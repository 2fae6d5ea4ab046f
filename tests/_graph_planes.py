"""Seeded packed dependency-graph planes and the scheduler's plan keys,
shared by the port's graph and isolation tests."""
import numpy as np

# The GraphScheduler stats both packages must agree on.
PLAN_KEYS = ("graphs", "buckets", "chunks", "closure_matmuls", "mxu_macs",
             "retries", "bisections", "watchdog_fired", "oom_events",
             "corrupt_chunks", "quarantined_rows", "faults_injected")


def pack_dense(dense):
    """0/1 uint8 [..., V, V] -> packed uint32 [..., V, words(V)], the
    columns padded to a whole word as pack_graph pads them."""
    V = dense.shape[-1]
    pad = np.zeros(dense.shape[:-1] + (max(V, 32) - V,), np.uint8)
    return np.packbits(np.concatenate([dense, pad], axis=-1), axis=-1,
                       bitorder="little").view(np.uint32)


def random_planes(rng, B, L, V, density, back=0.02):
    """Seeded packed planes [B, L, V, words(V)] (uint32): forward edges
    at ``density``, back edges (which can close cycles) at
    ``density * back``; column 31 and the last column set on some
    rows."""
    i, j = np.meshgrid(np.arange(V), np.arange(V), indexing="ij")
    p = np.where(j > i, density, density * back)
    dense = (rng.random((B, L, V, V)) < p).astype(np.uint8)
    if V >= 32:
        dense[:, :, : V // 2, 31] = 1
        dense[:, :, 0, V - 1] = 1
    return pack_dense(dense)
