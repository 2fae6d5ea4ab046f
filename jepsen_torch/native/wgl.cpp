// The port's native host engines: the WGL search, its threaded batch
// entry and the columnar encode walk.
//
// The C++ twin of the exact host engine
// (jepsen_torch/checkers/linearizable.py wgl_check) and of the slot walk
// in jepsen_torch/ops/encode.py encode_columnar. The Python layer
// (jepsen_torch/native/__init__.py) lowers a prepared history to flat
// int32 arrays (event type, process, op kind) plus the enumerated
// transition table (jepsen_torch.ops.statespace); this library runs the
// configuration-set search and the encode walk, and a threaded batch
// entry fans histories across cores. These are host engines: no device
// kernel runs here, and none is replaced.
//
// Configurations are packed into one uint64: the model state in the top
// byte, the linearized-pending-slot mask in the low 56 bits (pending
// windows wider than 56 report "unknown", and the caller decides the
// history with the Python engine). The config set is an open-addressed
// hash set rebuilt per event: the same eager-closure WGL the frontier
// kernel runs densely on the card (ops/csrc/wgl_frontier.cu).
//
// Build (jepsen_torch/native builds it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -o libwgl.so wgl.cpp -lpthread
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxMaskBits = 56;

// Event type codes (shared contract with the Python lowering).
constexpr int32_t EV_INVOKE = 0;
constexpr int32_t EV_OK = 1;
constexpr int32_t EV_INFO = 2;

// Verdicts.
constexpr int32_t VALID = 1;
constexpr int32_t INVALID = 0;
constexpr int32_t UNKNOWN = -1;  // exceeded max_configs or mask bits

inline uint64_t pack(int32_t state, uint64_t mask) {
  return (static_cast<uint64_t>(state) << kMaxMaskBits) | mask;
}
inline int32_t state_of(uint64_t c) {
  return static_cast<int32_t>(c >> kMaxMaskBits);
}
inline uint64_t mask_of(uint64_t c) {
  return c & ((1ULL << kMaxMaskBits) - 1);
}

// Open-addressed uint64 set. EMPTY (all ones) marks free buckets; the
// initial config (state 0, mask 0) packs to 0, which is a valid key.
class ConfigSet {
 public:
  static constexpr uint64_t kEmpty = ~0ULL;

  explicit ConfigSet(size_t cap_hint = 64) { rehash(round_up(cap_hint * 2)); }

  bool insert(uint64_t key) {  // true if newly added
    if (size_ * 2 >= buckets_.size()) rehash(buckets_.size() * 2);
    size_t i = slot(key);
    while (buckets_[i] != kEmpty) {
      if (buckets_[i] == key) return false;
      i = (i + 1) & (buckets_.size() - 1);
    }
    buckets_[i] = key;
    ++size_;
    return true;
  }

  size_t size() const { return size_; }
  const std::vector<uint64_t>& raw() const { return buckets_; }

  void clear() {
    std::fill(buckets_.begin(), buckets_.end(), kEmpty);
    size_ = 0;
  }

 private:
  static size_t round_up(size_t n) {
    size_t p = 16;
    while (p < n) p <<= 1;
    return p;
  }
  static uint64_t hash(uint64_t x) {  // splitmix64 finalizer
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
  }
  size_t slot(uint64_t key) const {
    return hash(key) & (buckets_.size() - 1);
  }
  void rehash(size_t n) {
    std::vector<uint64_t> old = std::move(buckets_);
    buckets_.assign(n, kEmpty);
    size_ = 0;
    for (uint64_t k : old)
      if (k != kEmpty) {
        size_t i = slot(k);
        while (buckets_[i] != kEmpty) i = (i + 1) & (n - 1);
        buckets_[i] = k;
        ++size_;
      }
  }

  std::vector<uint64_t> buckets_;
  size_t size_ = 0;
};

struct SlotState {
  std::vector<int32_t> slot_kind;  // kind occupying each slot, -1 free
  uint64_t free_mask;              // bit s set = slot s free
  std::vector<int32_t> slot_of_proc;
  int live = 0, max_live = 0;

  SlotState(int max_slots, int max_proc)
      : slot_kind(max_slots, -1), slot_of_proc(max_proc, -1) {
    free_mask = max_slots >= 64 ? ~0ULL : ((1ULL << max_slots) - 1);
  }
  // Lowest-free-first allocation: the shared discipline across the
  // Python, columnar and native encoders (keeps slot indices
  // < peak-live and clusters hot slots at low mask bits).
  bool exhausted() const { return free_mask == 0; }
  int alloc() {
    int s = __builtin_ctzll(free_mask);
    free_mask &= free_mask - 1;
    return s;
  }
  void release(int s) { free_mask |= 1ULL << s; }
};

}  // namespace

extern "C" {

// Exact WGL decision for one lowered history.
//
// ev_type/ev_proc/ev_kind: [n] event stream (EV_* codes; proc ids are
//   dense ints; kind indexes `target` rows). ev_noslot[i]=1 marks
//   invokes that need no slot (total-identity ops that never complete —
//   the encoder's drop rule).
// target: [K, V] row-major next-state table, -1 = inconsistent.
// out[0] = verdict, out[1] = index of first impossible ok event (-1).
int32_t jt_wgl_check(const int32_t* ev_type, const int32_t* ev_proc,
                     const int32_t* ev_kind, const uint8_t* ev_noslot,
                     int32_t n, const int32_t* target, int32_t K, int32_t V,
                     int32_t max_proc, int64_t max_configs, int32_t* out) {
  (void)K;
  out[0] = VALID;
  out[1] = -1;

  SlotState slots(kMaxMaskBits, max_proc);
  ConfigSet configs, next;
  configs.insert(pack(0, 0));

  std::vector<int32_t> occupied;  // slots currently holding an op
  std::vector<uint64_t> frontier, fresh;

  for (int32_t i = 0; i < n; ++i) {
    int32_t t = ev_type[i];
    if (t == EV_INVOKE) {
      if (ev_noslot && ev_noslot[i]) continue;
      if (slots.exhausted()) { out[0] = UNKNOWN; return UNKNOWN; }
      int s = slots.alloc();
      slots.slot_kind[s] = ev_kind[i];
      slots.slot_of_proc[ev_proc[i]] = s;
      if (++slots.live > slots.max_live) slots.max_live = slots.live;
    } else if (t == EV_INFO) {
      // Indeterminate: slot stays pinned forever.
      slots.slot_of_proc[ev_proc[i]] = -1;
    } else if (t == EV_OK) {
      int s = slots.slot_of_proc[ev_proc[i]];
      if (s < 0) continue;  // completion with no open invocation

      occupied.clear();
      for (int j = 0; j < kMaxMaskBits; ++j)
        if (slots.slot_kind[j] >= 0) occupied.push_back(j);

      // Closure: expand configs under application of pending ops.
      frontier.clear();
      for (uint64_t c : configs.raw())
        if (c != ConfigSet::kEmpty) frontier.push_back(c);
      while (!frontier.empty()) {
        fresh.clear();
        for (uint64_t c : frontier) {
          int32_t st = state_of(c);
          uint64_t m = mask_of(c);
          for (int j : occupied) {
            uint64_t bit = 1ULL << j;
            if (m & bit) continue;
            int32_t nxt = target[slots.slot_kind[j] * V + st];
            if (nxt < 0) continue;
            uint64_t c2 = pack(nxt, m | bit);
            if (configs.insert(c2)) fresh.push_back(c2);
          }
        }
        if (static_cast<int64_t>(configs.size()) > max_configs) {
          out[0] = UNKNOWN;
          return UNKNOWN;
        }
        frontier.swap(fresh);
      }

      // Filter: keep configs with bit s, clear it.
      uint64_t bit = 1ULL << s;
      next.clear();
      for (uint64_t c : configs.raw())
        if (c != ConfigSet::kEmpty && (mask_of(c) & bit))
          next.insert(c & ~bit);
      if (next.size() == 0) {
        out[0] = INVALID;
        out[1] = i;
        return INVALID;
      }
      std::swap(configs, next);

      // Free the slot.
      slots.slot_kind[s] = -1;
      slots.slot_of_proc[ev_proc[i]] = -1;
      slots.release(s);
      --slots.live;
    }
  }
  return VALID;
}

// Threaded batch entry over flattened histories.
// offsets: [B+1] into the ev_* arrays; targets likewise flattened with
// per-history (K, V) in dims[2b], dims[2b+1] and toffsets into targets.
void jt_wgl_check_batch(const int32_t* ev_type, const int32_t* ev_proc,
                        const int32_t* ev_kind, const uint8_t* ev_noslot,
                        const int64_t* offsets, const int32_t* targets,
                        const int64_t* toffsets, const int32_t* dims,
                        int32_t n_hist, int32_t max_proc,
                        int64_t max_configs, int32_t n_threads,
                        int32_t* out /* [B, 2] */) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::vector<int32_t> counter(1, 0);
  auto work = [&](int tid) {
    for (int32_t b = tid; b < n_hist; b += n_threads) {
      int64_t lo = offsets[b];
      int32_t n = static_cast<int32_t>(offsets[b + 1] - lo);
      jt_wgl_check(ev_type + lo, ev_proc + lo, ev_kind + lo,
                   ev_noslot ? ev_noslot + lo : nullptr, n,
                   targets + toffsets[b], dims[2 * b], dims[2 * b + 1],
                   max_proc, max_configs, out + 2 * b);
    }
  };
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
}

// Columnar encode walk: the C twin of ops/encode.py encode_columnar's
// per-line loop. Rows are independent, so the batch splits across
// threads; per row it runs the slot-allocation walk (lowest free slot
// per invoke, event emission per ok, overflow when the window exceeds
// S) and writes the trailing close event. Callers prefill ev_slots
// with the sentinel K and ev_opidx with -1.
//   type  int8  [B, N]   (-1 pad / 0 invoke / 1 ok / 2 info)
//   proc  int16 [B, N]
//   kind  int32 [B, N]
//   ev_slot  int8 [B, E]; ev_slots int8|int32 [B, E, S];
//   ev_opidx int32 [B, E]; max_live/cnt int32 [B]; overflow uint8 [B]
void jt_encode_walk(const int8_t* type, const int16_t* proc,
                    const int32_t* kind, int64_t B, int64_t N, int64_t E,
                    int32_t S, int32_t K, int32_t P, int8_t* ev_slot,
                    void* ev_slots_v, int32_t slots_wide,
                    int32_t* ev_opidx, int32_t* max_live, int32_t* cnt,
                    uint8_t* overflow, int32_t n_threads) {
  auto walk_row = [&](int64_t r) {
    std::vector<int32_t> table((size_t)S, K);
    std::vector<int32_t> slot_of((size_t)P, -1);
    uint32_t free_mask =
        (S >= 32) ? 0xFFFFFFFFu : ((uint32_t)1 << S) - 1;
    int32_t live = 0, peak = 0, c = 0;
    const int8_t* tr = type + r * N;
    const int16_t* pr = proc + r * N;
    const int32_t* kr = kind + r * N;
    int8_t* es = ev_slot + r * E;
    int32_t* eo = ev_opidx + r * E;
    int8_t* s8 = slots_wide ? nullptr : (int8_t*)ev_slots_v + r * E * S;
    int32_t* s32 = slots_wide ? (int32_t*)ev_slots_v + r * E * S
                              : nullptr;
    auto emit_table = [&](int64_t at) {
      if (s8)
        for (int32_t i = 0; i < S; ++i) s8[at * S + i] = (int8_t)table[i];
      else
        for (int32_t i = 0; i < S; ++i) s32[at * S + i] = table[i];
    };
    for (int64_t j = 0; j < N; ++j) {
      int8_t t = tr[j];
      if (t == 0) {  // invoke
        if (free_mask == 0) {
          overflow[r] = 1;
          break;  // matches the numpy walk: state frozen at overflow,
                  // trailing close still written (row is a failure)
        }
        uint32_t bit = free_mask & (~free_mask + 1u);
        int32_t slot = __builtin_ctz(bit);
        free_mask &= ~bit;
        slot_of[(size_t)pr[j]] = slot;
        table[(size_t)slot] = kr[j];
        if (++live > peak) peak = live;
      } else if (t == 1) {  // ok
        int32_t slot = slot_of[(size_t)pr[j]];
        if (slot < 0) continue;
        es[c] = (int8_t)slot;
        emit_table(c);
        eo[c] = (int32_t)j;
        table[(size_t)slot] = K;
        free_mask |= (uint32_t)1 << slot;
        slot_of[(size_t)pr[j]] = -1;
        ++c;
        --live;
      }
      // info: the pending slot stays pinned; nothing to track.
    }
    emit_table(c);  // trailing close/flush event
    max_live[r] = peak;
    cnt[r] = c;
  };

  if (n_threads <= 1 || B < 64) {
    for (int64_t r = 0; r < B; ++r) walk_row(r);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  for (int32_t t = 0; t < n_threads; ++t)
    pool.emplace_back([&] {
      for (int64_t r; (r = next.fetch_add(1)) < B;) walk_row(r);
    });
  for (auto& th : pool) th.join();
}

}  // extern "C"
