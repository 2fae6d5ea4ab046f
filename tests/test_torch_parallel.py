"""The port's multi-device routes (jepsen_torch.parallel, ops.cuda_shard)
against the reference's (jepsen_tpu.parallel) on the CPU.

The reference runs on the 8 virtual CPU devices tests/conftest.py
provisions for jax; the port on meshes of the CPU device named 8 times
(``provision.provisioned(8, "cpu")``, undone after each test so no mesh
leaks into other test files of the same worker). The same inputs, from a
seed with numpy or the shared Op-list generators, go through both:

  * ``frontier_sharded_kernel`` on meshes 4 x 2, 2 x 4 and 1 x 8 against
    the reference's on the same mesh shapes and against the port's
    single-device plain route (``get_kernel``): valid, bad and the packed
    frontier bit for bit, on an encoded corpus (per-row tables) and on
    random tables (a shared table, padding rows, a row failing on a
    top-slot completion and one surviving it);
  * ``data_sharded_kernel`` on 8 x 1 and ``summarize_verdicts``;
  * the production routes (``check_batch``, ``check_columnar``), result
    dicts field for field against ``check_batch_tpu`` /
    ``check_columnar``, each route checked in both ``DISPATCH_LOG``s;
  * ``should_shard``, $JT_SHARD_MIN_ROWS and the scheduler's
    ``shard_min_rows``;
  * a numpy model of ``csrc/wgl_shard.cu``'s three kernels, their
    layout, loops and thread strides (shard_close's from
    ``tests/_shard_model.py``, on the CTAs of its launch plan), driven by
    the port's round loop (``ops=``) and held to the reference at the
    local-window edges;
  * ``synth_wide_window_history`` against the reference's.

Random slots stay in [-1, W - 1], as an encoder writes them: past W - 1
the reference's single-device and sharded kernels complete on different
slots. Tolerance: none.
"""
import jax
import numpy as np
import pytest
import torch

from jepsen_tpu.checkers.linearizable import prepare_history as r_prep
from jepsen_tpu.history.columnar import ops_to_columnar as r_cols
from jepsen_tpu.models.core import cas_register as r_cas
from jepsen_tpu.ops import linearize as R
from jepsen_tpu.ops.encode import batch_encode as r_encode
from jepsen_tpu.parallel import checker_mesh as r_mesh
from jepsen_tpu.parallel import frontier_sharded_kernel as r_frontier
from jepsen_tpu.parallel.mesh import multihost_mesh as r_multihost
from jepsen_tpu.parallel.mesh import should_shard as r_should_shard
from jepsen_tpu.workloads.synth import synth_cas_batch as r_synth
from jepsen_tpu.workloads.synth import \
    synth_wide_window_history as r_wide

from _shard_model import model_close

from jepsen_torch import provision
from jepsen_torch.history.columnar import ops_to_columnar
from jepsen_torch.models.core import cas_register
from jepsen_torch.ops import cuda_shard
from jepsen_torch.ops import linearize as L
from jepsen_torch.ops.encode import EV_CLOSE, EV_FUSED, EV_OK
from jepsen_torch.parallel import (checker_mesh, data_sharded_kernel,
                                   frontier_sharded_kernel, multihost_mesh)
from jepsen_torch.parallel import frontier as PF
from jepsen_torch.parallel.mesh import (shard_min_rows, should_shard,
                                        summarize_verdicts)
from jepsen_torch.workloads.synth import synth_cas_batch
from jepsen_torch.workloads.synth import synth_wide_window_history

# One intra-op thread: the plain versions run many small ops, and test
# processes running side by side must not oversubscribe the cores.
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
MESHES = {"4x2": (4, 2), "2x4": (2, 4), "1x8": (1, 8)}


@pytest.fixture
def mesh8():
    """The port's production devices: the CPU named 8 times, for the
    test only."""
    with provision.provisioned(8, "cpu"):
        L._PROD_MESHES.clear()
        yield
    L._PROD_MESHES.clear()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def as_np(out):
    v, b, f = out
    return (np.asarray(v), np.asarray(b),
            np.asarray(f).view(np.uint32) if np.asarray(f).dtype != np.uint32
            else np.asarray(f))


def assert_same(got, want):
    for g, w in zip(as_np(got), as_np(want), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def counted_ops(calls):
    """The walk's plain entries, each call counted in ``calls``."""
    def counted(name):
        def run(*a, **kw):
            calls[name] += 1
            return getattr(cuda_shard, name)(*a, **kw)
        return run
    return {n: counted(n) for n in PF.OPS}


def single_device(V, W, args):
    """The port's single-device plain route on the same inputs."""
    return L.get_kernel(V, W)(*(t(a) for a in args))


@pytest.fixture(scope="module")
def corpus():
    """The reference test's corpus (``tests/test_parallel.py``): 16 CAS
    histories, encoded once by the reference's encoder."""
    hists = r_synth(16, seed0=11, n_procs=4, n_ops=16, n_values=3,
                    corrupt=0.3, p_info=0.1)
    enc = r_encode(r_cas(), [r_prep(h) for h in hists])
    assert not enc.failures
    return enc


def random_tables(seed, B, N, V, W, K1, shared):
    """Seeded random tables. Row 0 is all padding; row 1 completes on the
    top slot W - 1 at event 0 with a kind that reaches no state (it fails
    there), row 2 on the same slot with one that reaches state 1 from
    state 0 (it survives a top completion)."""
    rng = np.random.default_rng(seed)
    ev_type = rng.choice(np.array([0, 2, 2, 2, 3, 4], np.int8), (B, N))
    ev_slot = rng.integers(-1, W, (B, N)).astype(np.int8)
    ev_slots = rng.integers(-1, K1 + 1, (B, N, W))
    q = np.clip(ev_slot, 0, W - 1).astype(np.int64)
    ev_slots[np.arange(B)[:, None], np.arange(N)[None], q] = \
        rng.integers(0, K1 - 1, (B, N))
    shape = (K1, V) if shared else (B, K1, V)
    target = rng.integers(-1, V, shape).astype(np.int32)
    target[rng.random(shape) < 0.5] = -1
    target[..., K1 - 1, :] = -1
    ev_type[0] = 0
    for r, kind in ((1, K1 - 1), (2, K1 - 2)):
        ev_type[r, 0], ev_slot[r, 0] = EV_OK, W - 1
        ev_slots[r, 0, :] = K1 - 1
        ev_slots[r, 0, W - 1] = kind
    row = target[K1 - 2] if shared else target[2, K1 - 2]
    row[:] = -1
    row[0] = 1
    return (ev_type, ev_slot, ev_slots.astype(np.int8), target)


def ref_frontier(V, W, mesh_shape, args, shared=False):
    mesh = r_mesh(n_data=mesh_shape[0], n_frontier=mesh_shape[1])
    return r_frontier(V, W, mesh, shared_target=shared)(*args)


# ------------------------------------------------------------ the kernels

@pytest.mark.parametrize("name", list(MESHES))
def test_frontier_sharded_matches_reference(corpus, name):
    shape = MESHES[name]
    enc = corpus
    args = (enc.ev_type, enc.ev_slot, enc.ev_slots, enc.target)
    got = frontier_sharded_kernel(enc.V, enc.W,
                                  checker_mesh(*shape, devices=CPU8))(*args)
    assert_same(got, ref_frontier(enc.V, enc.W, shape, args))
    assert_same(got, single_device(enc.V, enc.W, args))
    assert not np.asarray(got[0]).all() and np.asarray(got[0]).any()


@pytest.mark.parametrize("name", list(MESHES))
def test_frontier_sharded_random_tables(name):
    """A shared table, padding rows and top-slot completions; the
    walk's exchange rounds ran."""
    n_data, D = MESHES[name]
    V, K1, W = 8, 6, 4 + (D.bit_length() - 1)
    args = random_tables(7 + D, 4 * n_data, 12, V, W, K1, shared=True)
    calls = {n: 0 for n in PF.OPS}
    rounds = PF.ROUNDS
    got = frontier_sharded_kernel(V, W, checker_mesh(n_data, D,
                                                     devices=CPU8),
                                  shared_target=True)(
        *args, ops=counted_ops(calls))
    assert_same(got, ref_frontier(V, W, (n_data, D), args, shared=True))
    assert_same(got, single_device(V, W, args))
    valid, bad, _ = as_np(got)
    assert not valid[1] and bad[1] == 0 and valid[0]
    assert PF.ROUNDS > rounds and calls["shard_image"] > 0


def test_data_sharded_8x1_and_summary(corpus):
    enc = corpus
    args = (enc.ev_type, enc.ev_slot, enc.ev_slots, enc.target)
    got = data_sharded_kernel(enc.V, enc.W,
                              checker_mesh(8, 1, devices=CPU8))(*args)
    assert_same(got, single_device(enc.V, enc.W, args))
    want = R.batch_kernel(enc.V, enc.W)(*args)
    assert_same(got, want)
    from jepsen_tpu.parallel.mesh import summarize_verdicts as r_summary
    assert summarize_verdicts(got[0]) == r_summary(want[0])
    assert summarize_verdicts(got[0])["invalid"] > 0


# ----------------------------------------------------- production routes

def routes(log):
    return {(p, w) for p, _, w, _ in log}


def both_check_batch(hists_r, hists_p, **kw):
    R.DISPATCH_LOG.clear()
    L.DISPATCH_LOG.clear()
    want = R.check_batch_tpu(r_cas(), hists_r, **kw)
    got = L.check_batch(cas_register(), hists_p, device="cpu", **kw)
    return got, want, routes(L.DISPATCH_LOG), routes(R.DISPATCH_LOG)


def test_production_route_data_sharded(mesh8):
    kw = dict(seed0=31, n_procs=4, n_ops=12, n_values=3, corrupt=0.4)
    got, want, pl, rl = both_check_batch(r_synth(80, **kw),
                                         synth_cas_batch(80, **kw))
    assert got == want
    assert {p for p, _ in pl} == {p for p, _ in rl} == {"dataN"}
    assert {r["valid"] for r in got} == {True, False}


def test_production_route_frontier_w17(mesh8):
    got, want, pl, rl = both_check_batch(
        [r_wide(width=17), r_wide(width=17, invalid=True)],
        [synth_wide_window_history(width=17),
         synth_wide_window_history(width=17, invalid=True)])
    assert got == want
    assert ("frontier", 17) in pl and ("frontier", 17) in rl
    assert got[0]["valid"] is True and got[1]["valid"] is False
    assert "fallback" not in got[0] and "fallback" not in got[1]
    assert got[1]["op"]["f"] == "read"


def test_production_route_frontier_columnar_w18(mesh8):
    hr = [r_wide(width=18), r_wide(width=18, invalid=True)]
    hp = [synth_wide_window_history(width=18),
          synth_wide_window_history(width=18, invalid=True)]
    R.DISPATCH_LOG.clear()
    L.DISPATCH_LOG.clear()
    want = R.check_columnar(r_cas(), r_cols(r_cas(), hr))
    got = L.check_columnar(cas_register(), ops_to_columnar(cas_register(),
                                                           hp),
                           device="cpu")
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    assert ("frontier", 18) in routes(L.DISPATCH_LOG)
    assert ("frontier", 18) in routes(R.DISPATCH_LOG)
    assert got[0].tolist() == [True, False]
    assert int(got[1][1]) == hp[1][-1].index


@pytest.mark.parametrize("width", [17, 18])
def test_single_device_wide_window(monkeypatch, width):
    """No mesh (nothing provisioned, no card): W 17-18 take data1wide,
    verdicts and bad ops through the columnar entry (the dense frontiers
    of these rows make a config sample a few seconds of host decode, so
    the Op-list dicts are checked at W 17 on the frontier route)."""
    monkeypatch.setattr(R, "production_mesh", lambda n_frontier=1: None)
    hr = [r_wide(width=width), r_wide(width=width, invalid=True)]
    hp = [synth_wide_window_history(width=width),
          synth_wide_window_history(width=width, invalid=True)]
    R.DISPATCH_LOG.clear()
    L.DISPATCH_LOG.clear()
    want = R.check_columnar(r_cas(), r_cols(r_cas(), hr))
    got = L.check_columnar(cas_register(), ops_to_columnar(cas_register(),
                                                           hp),
                           device="cpu")
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    assert ("data1wide", width) in routes(L.DISPATCH_LOG)
    assert ("data1wide", width) in routes(R.DISPATCH_LOG)
    assert got[0].tolist() == [True, False]
    assert int(got[1][1]) == hp[1][-1].index


def test_window_past_one_device_falls_back(monkeypatch):
    """W 19 with no mesh: the encoder cannot window it, so the row goes
    to the host fallback, flagged with the reason. The exact host engine
    takes over a minute a row on this history (2^18 subsets), so both
    packages get a recording fallback in its place."""
    monkeypatch.setattr(R, "production_mesh", lambda n_frontier=1: None)
    monkeypatch.setattr(R, "device_frontier_capacity",
                        lambda: R.SINGLE_DEVICE_EXTRA_SLOTS)
    assert L.device_frontier_capacity("cpu") == L.SINGLE_DEVICE_EXTRA_SLOTS
    seen = []

    def host(model, h):
        seen.append(len(h))
        return {"valid": False, "op": h[-1].to_dict()}

    got, want, pl, _ = both_check_batch(
        [r_wide(width=19, invalid=True)],
        [synth_wide_window_history(width=19, invalid=True)],
        host_fallback=host)
    assert got == want
    assert seen == [20, 20]
    assert got[0]["valid"] is False and "pending" in got[0]["fallback"]
    assert not pl


def test_multihost_mesh(mesh8, corpus):
    mesh = multihost_mesh(n_hosts=2)
    assert mesh.axis_names == ("dcn", "data", "frontier")
    assert mesh.devices.shape == r_multihost(n_hosts=2).devices.shape
    enc = corpus
    args = (enc.ev_type, enc.ev_slot, enc.ev_slots, enc.target)
    got = data_sharded_kernel(enc.V, enc.W, mesh)(*args)
    assert_same(got, R.batch_kernel(enc.V, enc.W)(*args))
    for kw in (dict(n_hosts=3, n_data=4), dict(n_hosts=2, n_frontier=8)):
        with pytest.raises(ValueError):
            r_multihost(**kw)
        with pytest.raises(ValueError, match="needs"):
            multihost_mesh(**kw)


def test_no_mesh_without_provisioning(monkeypatch):
    # a host without a card: nothing provisioned means no device at all
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert provision.devices() == []
    assert L.production_mesh(1, "cpu") is None
    assert L.production_mesh(2, "cpu") is None
    with provision.provisioned(8, "cpu"):
        assert L.production_mesh(1, "cpu").shape == {"data": 8,
                                                     "frontier": 1}
        assert L.production_mesh(4, "cpu").shape == {"data": 2,
                                                     "frontier": 4}
        assert L.production_mesh(16, "cpu") is None
        # a mesh serves only the callers of its device type
        assert L.production_mesh(1, "cuda") is None
        assert L.device_frontier_capacity("cpu") == 3
    assert provision.devices() == []


@pytest.mark.parametrize("env", [None, "3", "many", "0"])
def test_should_shard_and_env(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JT_SHARD_MIN_ROWS", raising=False)
    else:
        monkeypatch.setenv("JT_SHARD_MIN_ROWS", env)
    from jepsen_tpu.parallel.mesh import shard_min_rows as r_min
    assert shard_min_rows() == r_min()
    mesh, rmesh = checker_mesh(8, 1, devices=CPU8), r_mesh(8, 1)
    for rows in (0, 7, 8, 23, 24, 63, 64, 65, 1000):
        assert should_shard(rows, mesh) == r_should_shard(rows, rmesh)
    assert not should_shard(10**6, None)


@pytest.mark.parametrize("floor", [None, 50, 1 << 30])
def test_scheduler_shard_min_rows(mesh8, floor):
    """The scheduler hands a bucket of at least ``shard_min_rows`` rows
    (default: the mesh's data devices x $JT_SHARD_MIN_ROWS) to the
    blocking sharded route, as the reference's does."""
    kw = dict(seed0=5, n_procs=3, n_ops=10, n_values=3, corrupt=0.3)
    opts = {"fuse_width": 1}
    if floor is not None:
        opts["shard_min_rows"] = floor
    R.DISPATCH_LOG.clear()
    L.DISPATCH_LOG.clear()
    want = R.check_batch_tpu(r_cas(), r_synth(96, **kw),
                             scheduler_opts=dict(opts, prewarm=False,
                                                 wgl_backend="xla"))
    got = L.check_batch(cas_register(), synth_cas_batch(96, **kw),
                        device="cpu", scheduler_opts=opts)
    assert got == want
    sharded = {p for p, _ in routes(L.DISPATCH_LOG)} & {"dataN"}
    assert sharded == ({p for p, _ in routes(R.DISPATCH_LOG)} & {"dataN"})
    assert bool(sharded) == (floor != 1 << 30)


# ------------------------------------------------ the kernels' numpy model

def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _strided(n, T):
    """Indices 0..n-1 in the order a block of T threads covers them (thread
    t: t, t + T, ...); each exactly once."""
    out = np.concatenate([np.arange(t, n, T) for t in range(min(T, n))]) \
        if n else np.zeros(0, np.int64)
    assert np.array_equal(np.sort(out), np.arange(n))
    return out


def _kind(ev_slots, K1, row, e, slot):
    k = int(ev_slots[row, e, slot])
    k = k + K1 if k < 0 else k
    return min(max(k, 0), K1 - 1)


def _tab(target, K1, V, NW, row, k):
    """stage_row: [V][NW] packed one-hot rows, and whether any reaches."""
    t = target if target.ndim == 2 else target[row]
    to = t[k].astype(np.int64)
    tab = np.zeros((V, NW), np.uint32)
    for w in range(NW):
        r = to - 32 * w
        ok = (r >= 0) & (r < 32)
        tab[ok, w] = np.left_shift(np.uint32(1), r[ok].astype(np.uint32))
    return tab, bool((to >= 0).any())


def _image_of(src, tab):
    """image_of over masks: src [NW, P] uint32, the set-bit loop of each
    word, as the kernel runs it (a state at a time)."""
    NW, P = src.shape
    img = np.zeros((NW, P), np.uint32)
    for w in range(NW):
        for s in range(min(32, tab.shape[0] - 32 * w)):
            hit = (src[w] >> np.uint32(s)) & np.uint32(1)
            if hit.any():
                img |= hit.astype(bool)[None, :] * tab[32 * w + s][:, None]
    return img


def model_image(F, ev_type, ev_slot, ev_slots, target, valid, *, e, b, d,
                WL, W, V, send=None):
    F8 = _np(F).view(np.uint32)
    rows, NW, M = F8.shape
    typ, slots, tgt, vl = _np(ev_type), _np(ev_slots), _np(target), \
        _np(valid)
    K1, T = tgt.shape[-2], cuda_shard.threads(WL)
    out = np.zeros_like(F8)
    for row in range(rows):
        active = vl[row] and int(typ[row, e]) in (EV_OK, EV_FUSED,
                                                  EV_CLOSE)
        if not active:
            continue
        tab, reach = _tab(tgt, K1, V, NW, row,
                          _kind(slots, K1, row, e, WL + b))
        if reach:
            m = _strided(M, T)
            out[row][:, m] = _image_of(F8[row][:, m], tab)
    send = torch.empty_like(F) if send is None else send
    send.copy_(torch.from_numpy(out.view(np.int32)))
    return send


def model_commit(F, Fbad, top, ev_type, ev_slot, ev_slots, target, valid,
                 bad, nonempty, *, e, idx, d, WL, W, V):
    F8, Fb8 = _np(F).view(np.uint32), _np(Fbad).view(np.uint32)
    rows, NW, M = F8.shape
    typ, slot, vl = _np(ev_type), _np(ev_slot), _np(valid)
    bd, ne = _np(bad), _np(nonempty)
    T = cuda_shard.threads(WL)
    for row in range(rows):
        if not vl[row] or int(typ[row, e]) not in (EV_OK, EV_FUSED):
            continue
        j = _strided(NW * M, T)
        if not ne[row]:
            Fb8[row].reshape(-1)[j] = F8[row].reshape(-1)[j]
            F8[row].reshape(-1)[j] = 0
            vl[row] = False
            bd[row] = min(int(bd[row]), idx)
            continue
        q = min(max(int(slot[row, e]), 0), W - 1)
        if q < WL:
            bit = 1 << q
            p = _strided(M >> 1, T)
            m = ((p & ~(bit - 1)) << 1) | (p & (bit - 1))
            F8[row][:, m] = F8[row][:, m | bit]
            F8[row][:, m | bit] = 0
            continue
        b = q - WL
        src = None if (d >> b) & 1 or top[b] is None \
            else _np(top[b]).view(np.uint32)[row].reshape(-1)
        F8[row].reshape(-1)[j] = 0 if src is None else src[j]


MODEL_OPS = {"shard_close": model_close, "shard_image": model_image,
             "shard_commit": model_commit}


@pytest.mark.parametrize("WL,D,NW", [(1, 2, 1), (5, 4, 1), (8, 2, 2),
                                     (9, 8, 1), (16, 2, 1)])
def test_kernel_model_at_local_window_edges(WL, D, NW):
    """The numpy model of the three kernels, through the port's round
    loop, against the reference's single-device kernel (and the port's
    sharded plain route) at local windows 1, 5 (one warp's masks), 8, 9
    and 16, at one and two state words."""
    W = WL + D.bit_length() - 1
    V = 8 if NW == 1 else 34
    K1, B, N = 5, (4 if WL < 16 else 3), (8 if WL < 16 else 3)
    args = random_tables(100 * WL + D, B, N, V, W, K1, shared=NW == 2)
    mesh = checker_mesh(1, D, devices=CPU8)
    rounds = PF.ROUNDS
    got = frontier_sharded_kernel(V, W, mesh, shared_target=NW == 2)(
        *args, ops=MODEL_OPS)
    ref = jax.jit(jax.vmap(R.make_kernel(V, W),
                           in_axes=(0, 0, 0, None if NW == 2 else 0)))
    assert_same(got, ref(*args))
    plain = frontier_sharded_kernel(V, W, mesh, shared_target=NW == 2)(
        *args)
    assert_same(got, plain)
    assert PF.ROUNDS > rounds


def test_synth_wide_window_history_matches_reference():
    for kw in (dict(width=17), dict(width=18, invalid=True),
               dict(width=19, n_values=3, seed=4)):
        got = [o.to_dict() for o in synth_wide_window_history(**kw)]
        want = [o.to_dict() for o in r_wide(**kw)]
        assert got == want
