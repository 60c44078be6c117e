// Kernels 3 and 4: the CSR gathers, the second pass of count -> prefix-sum ->
// gather retrieval, as one load-balanced search per tile of output slots.
//
// Replaces the Pallas kernels `csr_gather_2d` (src/repro/kernels/bucket_probe.py:161)
// and `csr_gather_batched_2d` (:206), whose body is `_gather_tile` (:81).
// For each output slot of block b (one CSR):
//   row  = the row whose run holds the slot (searchsorted(offsets_b, slot, right) - 1)
//   vals = table[starts_b[row] + slot - offsets_b[row]]
//   rows = row
// with (fill, -1) in slots at or past the block's total.  Rows with a zero
// count share an offset; the row found is the last of them, the one whose run
// holds the slot, exactly as the TPU kernel's bisection finds it.
//
// Four entries share one device routine (`gather_tiles`):
// - `csr_gather` (one CSR) and `csr_gather_batched` (one CSR per source over
//   a shared table): the Pallas functions' interface, exclusive offsets
//   (num_rows + 1) given by the caller.
// - `csr_gather_owners`: the owner side of a retrieve, every (owner, source)
//   block and every layer in one launch.  Run descriptors (L, D_o, D_s, R)
//   as the locate leaves them, each start indexing its own layer's table
//   (D_o, M_l), read in place through a small device array of L (base
//   pointer, row stride, length) triples, so a stack of any depth is one
//   launch.  Slot n of block (o, s) packs its layers' runs in
//   epoch order from the inclusive prefix sum of the slots' totals: the
//   slot-major, layer-minor segment the interleaved gather produced, with no
//   interleaved copy and no concatenated table.  Writes the segment
//   (D_o, D_s, seg_capacity) and each block's overflow, no row ids.
// - `csr_gather_queriers`: the querier side, every querier in one launch,
//   each gathering from its own row of the returned segments (a row stride);
//   writes values, row ids, the offsets clamped to the capacity and each
//   querier's overflow.
// Value columns: every entry takes tables of C int32 columns a row, row-major
// ((M, C); C = 1 is the 1-D table), and writes C words a slot.  A slot's row
// and source word are resolved once; then its C words move together: one
// 16-byte load and store for C = 4 (the wrapper keeps table bases 16-byte
// aligned), a loop over the columns for other C.  C = 1 is the
// instantiation the 1-column table has always run (`gather_tiles<kThreads, 1>`).  The
// reference gathers its columns through the same row ids after the kernel
// (src/repro/kernels/ops.py:176-212).
//
// The new entries take one inclusive prefix sum over all their blocks' rows
// (one flat `cumsum`: a scan per block row is one slow launch at D > 1), and
// each block subtracts the sum before its first row, modulo 2^32, so a block
// whose own total is below 2^31 comes out exact; the Pallas-interface
// entries pass their offsets from index 1, where the sum before a block's
// first row is its offsets[0] == 0.
//
// Bound on the H100: memory.  Bytes once (a run's start is needed only where
// its count is > 0, so starts count by the 32-byte sectors that hold one):
// owners read the (L, D_o, D_s, R) counts, those starts, one prefix sum per
// slot, the picked table words, and write the segment and B overflow words;
// queriers read one prefix sum per row, those starts and the picked words,
// and write values, row ids and clamped offsets; the Pallas-interface
// entries read offsets, those starts and the picked words and write values
// and row ids.
//
// Why a search per tile and not per slot.  The first version bisected the
// whole prefix-sum array for every output slot: bit_length(N + 1) dependent
// loads (23-26 at D = 1), only the top levels cached, one random chain a
// slot.  Neighbouring output slots belong to the same or neighbouring rows,
// so here a CTA takes a tile of 2048 slots of one block: two warps find the
// tile's first and last rows with a 32-ary search (a probe per lane and a
// ballot, about 6 rounds at D = 1), the CTA stages that row range's offsets
// into shared memory with coalesced loads (a range longer than the stage,
// which only runs of many empty rows make, is searched in place in device
// memory), and each thread resolves 2 groups of 4 consecutive slots: a
// bisection of the staged range for a group's first slot, a galloping step
// for the next.  On the owner side each slot then walks its row's layers
// (all L counts loaded at once, neighbouring slots on neighbouring rows, so
// a warp's loads coalesce).  The 8 table words of a thread are loaded
// together; within a run neighbouring slots read neighbouring words.  Groups
// of 4 slots are stored with one 16-byte store where the capacity is a
// multiple of 4.  The grid covers every (block, tile) pair, so one key with
// 2^16 matches spreads over 32 tiles.  `wgmma` has no product to compute
// here, and TMA moves tiles, not runs of data-dependent length: neither has
// a part in this kernel.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// A CTA's threads are a template parameter (kThreads: 128, 256 or 512; the
// register arrays and __launch_bounds__ need it at compile time), so its
// tile of output slots, kThreads * kSlots, is block_rows = kThreads / 16
// rows of 128 slots (8, 16 or 32; 16 by default).
constexpr int kVec = 4;                            // consecutive slots: one 16-byte store
constexpr int kGroups = 2;                         // groups of kVec slots a thread
constexpr int kSlots = kVec * kGroups;
constexpr int kStage = 4096;                       // staged offsets (16 KB)

struct Args {
  const int32_t* incl;    // (B, R) inclusive prefix sums of the rows' totals, each
                          // block's from incl_b[-1] (0 for the first block)
  long long incl_stride;  // words between blocks of incl
  const int32_t* starts;  // (L, B, R) run starts into each layer's table row
  const int32_t* counts;  // (L, B, R) run lengths (unused when L == 1)
  // Block b reads row b / owners_div of each layer's table: layer l's base
  // pointer, words between rows and words a row at layer_tables[3 l ..],
  // on the device; or, where layer_tables is null, the one table below.
  const long long* layer_tables;
  const int32_t* table;
  long long table_stride;  // words between rows (0: one shared table)
  long long table_len;     // table rows (of C words) a row
  int cols;                // C: words a table row and an output slot
  int32_t* vals;          // (B, cap, C)
  int32_t* rows;          // (B, cap) row ids, or null
  int32_t* off_out;       // (B, R + 1) exclusive offsets clamped to cap, or null
  int32_t* dropped;       // (B,) max(0, total - cap), or null
  long long cap;
  int num_rows;           // R
  int num_blocks;         // B
  int owners_div;
  int num_layers;         // L
  int tiles;              // CTAs a block
  int fill;
};

// Row `row` of layer l's table and its length in table rows.
struct TableRow {
  const int32_t* base;
  long long len;
};

__device__ __forceinline__ TableRow table_row(const Args& g, int l, int row) {
  if (g.layer_tables == nullptr) {
    return {g.table + row * g.table_stride, g.table_len};
  }
  const long long* e = g.layer_tables + 3 * l;
  return {reinterpret_cast<const int32_t*>(__ldg(e)) + row * __ldg(e + 1), __ldg(e + 2)};
}

// A block's inclusive sums: the flat sums from its first row, less the sum
// before it (base), modulo 2^32.
struct BlockSums {
  const int32_t* incl;
  unsigned base;
  __device__ __forceinline__ int operator[](long long j) const {
    return static_cast<int>(static_cast<unsigned>(__ldg(incl + j)) - base);
  }
  // Exclusive offset i: 0, then the inclusive sums.
  __device__ __forceinline__ int off(int i) const { return i == 0 ? 0 : (*this)[i - 1]; }
};

// First j in [lo, hi) with a[j] > x (hi if none), by the whole warp: each
// round every lane probes the end of one of 32 pieces and a ballot keeps the
// first piece whose end lies above x.
__device__ int warp_first_above(const BlockSums& a, int lo, int hi, int x) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long step = (static_cast<long long>(hi - lo) + 31) >> 5;
    const long long end = lo + (lane + 1) * step;
    const int probe = static_cast<int>((end < hi ? end : hi) - 1);
    const unsigned above = __ballot_sync(0xffffffffu, a[probe] > x);
    if (above == 0) return hi;
    const long long j = __ffs(above) - 1;
    const long long piece_end = lo + (j + 1) * step;
    hi = static_cast<int>(piece_end < hi ? piece_end : hi);
    lo = static_cast<int>(lo + j * step);
  }
  const bool in = lo + lane < hi;
  const unsigned above = __ballot_sync(0xffffffffu, in && a[lo + lane] > x);
  return above ? lo + __ffs(above) - 1 : hi;
}

// The tile's offsets s(i) = offset of row r0 + i, i in [0, ns]: staged in
// shared memory, or read in place from the inclusive sums.
template <bool kStaged>
struct RowOffsets {
  const int* stage;
  BlockSums sums;
  int r0;
  __device__ __forceinline__ int operator()(int i) const {
    return kStaged ? stage[i] : sums.off(r0 + i);
  }
};

// Last i in [lo, hi) with s(i) <= x, given s(lo) <= x < s(hi).
template <class S>
__device__ __forceinline__ int bisect(const S& s, int lo, int hi, int x) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (s(mid) <= x) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// From row cur with s(cur) <= x, the last row with s(row) <= x, galloping
// over the rows between (s(ns) > x).
template <class S>
__device__ __forceinline__ int advance(const S& s, int cur, int ns, int x) {
  if (s(cur + 1) > x) return cur;
  int lo = cur + 1;
  int step = 1;
  int hi = lo + 1;
  while (hi < ns && s(hi) <= x) {
    lo = hi;
    step <<= 1;
    hi = lo + step;
  }
  return bisect(s, lo, hi < ns ? hi : ns, x);
}

__device__ __forceinline__ void store_group(int32_t* out, long long s0, int p_end,
                                            const int* v, bool vec) {
  if (vec && s0 + kVec <= p_end) {
    *reinterpret_cast<int4*>(out + s0) = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (s0 + j < p_end) out[s0 + j] = v[j];
  }
}

// Group gi's row ids (-1 where the slot holds no value), where asked for.
template <bool kStaged>
__device__ __forceinline__ void store_rows(const Args& g, const RowOffsets<kStaged>& s,
                                           const int (&row)[kSlots], const int (&layer)[kSlots],
                                           int gi, int s0, int p_end, bool vec,
                                           long long out0) {
  if (g.rows == nullptr) return;
  int r[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = gi * kVec + j;
    r[j] = layer[i] >= 0 ? s.r0 + row[i] : -1;
  }
  store_group(g.rows + out0, s0, p_end, r, vec);
}

// Resolve and store this thread's kSlots slots of the tile.  kCols: the
// table's columns (0: g.cols, any number, in a loop).
template <int kThreads, bool kStaged, int kCols>
__device__ __forceinline__ void gather_slots(const Args& g, int b,
                                             const RowOffsets<kStaged>& s, int ns,
                                             int p0, int p_end, int valid_end) {
  const int num_rows = g.num_rows;
  int row[kSlots];
  int k[kSlots];
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    const int s0 = p0 + gi * kThreads * kVec + static_cast<int>(threadIdx.x) * kVec;
    int cur = -1;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int x = s0 + j;
      const int i = gi * kVec + j;
      row[i] = -1;
      k[i] = 0;
      if (x < valid_end) {
        cur = cur < 0 ? bisect(s, 0, ns, x) : advance(s, cur, ns, x);
        row[i] = cur;
        k[i] = x - s(cur);
      }
    }
  }
  const long long layer_words = static_cast<long long>(g.num_blocks) * num_rows;
  const long long block_row0 = static_cast<long long>(b) * num_rows + s.r0;
  int layer[kSlots];
  if (g.num_layers == 1) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) layer[i] = row[i] >= 0 ? 0 : -1;
  } else {
    // Slot-major, layer-minor: the slot's offset within its row walks the
    // layers' counts in epoch order.  Every layer's count is loaded (the
    // loads do not wait on the walk).
#pragma unroll
    for (int i = 0; i < kSlots; ++i) layer[i] = -1;
    for (int l = 0; l < g.num_layers; ++l) {
      const int32_t* cl = g.counts + l * layer_words + block_row0;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int c = row[i] >= 0 ? __ldg(cl + row[i]) : 0;
        if (layer[i] < 0) {
          if (k[i] < c) {
            layer[i] = l;
          } else {
            k[i] -= c;
          }
        }
      }
    }
  }
  const int table_idx = b / g.owners_div;
  const int cols = kCols ? kCols : g.cols;
  const int32_t* src[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    src[i] = nullptr;
    const int l = layer[i];
    if (l >= 0) {
      long long at = static_cast<long long>(
          __ldg(g.starts + l * layer_words + block_row0 + row[i])) + k[i];
      const TableRow tr = table_row(g, l, table_idx);
      at = at < 0 ? 0 : (at > tr.len - 1 ? tr.len - 1 : at);
      if (tr.len > 0) {
        src[i] = tr.base + at * cols;
      } else {
        layer[i] = -1;  // an empty table holds no valid slot (as the plain twin)
      }
    }
  }
  const long long out0 = static_cast<long long>(b) * g.cap;
  const bool vec = (g.cap & (kVec - 1)) == 0;
  if constexpr (kCols == 1) {
    int v[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) v[i] = src[i] ? __ldg(src[i]) : g.fill;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const int s0 = p0 + gi * kThreads * kVec + static_cast<int>(threadIdx.x) * kVec;
      store_group(g.vals + out0, s0, p_end, v + gi * kVec, vec);
      store_rows(g, s, row, layer, gi, s0, p_end, vec, out0);
    }
    return;
  } else if constexpr (kCols == 4) {
    // A slot's 4 columns: one 16-byte load and one 16-byte store.
    int4 v[kSlots];
    const int4 fill4 = make_int4(g.fill, g.fill, g.fill, g.fill);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      v[i] = src[i] ? __ldg(reinterpret_cast<const int4*>(src[i])) : fill4;
    }
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const int s0 = p0 + gi * kThreads * kVec + static_cast<int>(threadIdx.x) * kVec;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (s0 + j < p_end) {
          *reinterpret_cast<int4*>(g.vals + (out0 + s0 + j) * 4) = v[gi * kVec + j];
        }
      }
    }
  } else {
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const int s0 = p0 + gi * kThreads * kVec + static_cast<int>(threadIdx.x) * kVec;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int i = gi * kVec + j;
        if (s0 + j >= p_end) continue;
        int32_t* out = g.vals + (out0 + s0 + j) * cols;
        for (int c = 0; c < cols; ++c) out[c] = src[i] ? __ldg(src[i] + c) : g.fill;
      }
    }
  }
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    const int s0 = p0 + gi * kThreads * kVec + static_cast<int>(threadIdx.x) * kVec;
    store_rows(g, s, row, layer, gi, s0, p_end, vec, out0);
  }
}

template <int kThreads, int kCols>
__global__ void __launch_bounds__(kThreads)
gather_tiles(const Args g) {
  constexpr int kTile = kThreads * kSlots;  // output slots a CTA
  __shared__ int stage[kStage];
  __shared__ int tile_rows[2];
  const int b = blockIdx.x / g.tiles;
  const int tile = blockIdx.x - b * g.tiles;
  const int num_rows = g.num_rows;
  const int32_t* incl = g.incl + b * g.incl_stride;
  const BlockSums sums{incl, b && num_rows ? static_cast<unsigned>(__ldg(incl - 1)) : 0u};
  const long long total = num_rows ? sums[num_rows - 1] : 0;

  // The clamped offsets, spread over the block's tiles, and the overflow.
  if (g.off_out != nullptr) {
    int32_t* out = g.off_out + static_cast<long long>(b) * (num_rows + 1);
    const long long per = (static_cast<long long>(num_rows) + g.tiles) / g.tiles;
    const long long e0 = tile * per;
    const long long e1 = e0 + per < num_rows + 1 ? e0 + per : num_rows + 1;
    for (long long e = e0 + threadIdx.x; e < e1; e += kThreads) {
      const long long o = sums.off(static_cast<int>(e));
      out[e] = static_cast<int32_t>(o < g.cap ? o : g.cap);
    }
  }
  if (g.dropped != nullptr && tile == 0 && threadIdx.x == 0) {
    g.dropped[b] = static_cast<int32_t>(total > g.cap ? total - g.cap : 0);
  }

  const long long p0l = static_cast<long long>(tile) * kTile;
  if (p0l >= g.cap) return;
  const int p0 = static_cast<int>(p0l);
  const int p_end = static_cast<int>(p0l + kTile < g.cap ? p0l + kTile : g.cap);
  const int valid_end = static_cast<int>(total < p_end ? total : p_end);
  if (valid_end <= p0) {  // past the total: fill only
    RowOffsets<true> none{stage, sums, 0};
    gather_slots<kThreads, true, kCols>(g, b, none, 0, p0, p_end, p0);
    return;
  }
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    // The rows of the tile's first and last valid slots: the first row whose
    // inclusive sum exceeds the slot.
    const int r = warp_first_above(sums, 0, num_rows, warp == 0 ? p0 : valid_end - 1);
    if ((threadIdx.x & 31) == 0) tile_rows[warp] = r;
  }
  __syncthreads();
  const int r0 = tile_rows[0];
  const int ns = tile_rows[1] - r0 + 1;  // rows r0 .. r1; s(ns) is row r1's end
  if (ns + 1 > kStage) {
    gather_slots<kThreads, false, kCols>(g, b, RowOffsets<false>{stage, sums, r0}, ns, p0,
                                         p_end, valid_end);
    return;
  }
  constexpr int kUnroll = 4;
  for (int base = 0; base <= ns; base += kThreads * kUnroll) {
    int w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + static_cast<int>(threadIdx.x);
      w[u] = i <= ns ? sums.off(r0 + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + static_cast<int>(threadIdx.x);
      if (i <= ns) stage[i] = w[u];
    }
  }
  __syncthreads();
  gather_slots<kThreads, true, kCols>(g, b, RowOffsets<true>{stage, sums, r0}, ns, p0, p_end,
                                      valid_end);
}

template <int kThreads>
void launch_cols(const Args& a, dim3 blocks, cudaStream_t st) {
  if (a.cols == 1) {
    gather_tiles<kThreads, 1><<<blocks, kThreads, 0, st>>>(a);
  } else if (a.cols == 4) {
    gather_tiles<kThreads, 4><<<blocks, kThreads, 0, st>>>(a);
  } else {
    gather_tiles<kThreads, 0><<<blocks, kThreads, 0, st>>>(a);
  }
}

bool valid_threads(int threads) { return threads == 128 || threads == 256 || threads == 512; }

int tiles_for(long long capacity, int threads) {
  const long long tile = static_cast<long long>(threads) * kSlots;
  const long long tiles = (capacity + tile - 1) / tile;
  return static_cast<int>(tiles < 1 ? 1 : (tiles > INT_MAX ? INT_MAX : tiles));
}

// a.tiles is set here from the capacity and the CTA's threads.
int launch(Args a, int threads, void* stream) {
  if (!valid_threads(threads) || a.cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = tiles_for(a.cap, threads);
  if (a.num_blocks > 0) {
    const long long grid = static_cast<long long>(a.tiles) * a.num_blocks;
    if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 blocks(static_cast<unsigned>(grid));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (threads == 128) {
      launch_cols<128>(a, blocks, st);
    } else if (threads == 256) {
      launch_cols<256>(a, blocks, st);
    } else {
      launch_cols<512>(a, blocks, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The Pallas functions' interface: exclusive offsets (S, num_rows + 1); a
// table of table_len rows of `cols` words.
int pallas_interface(const void* offsets, const void* starts, const void* table,
                     long long table_len, int cols, void* vals, void* rows,
                     long long capacity, int num_rows, int num_sources, int fill,
                     int threads, void* stream) {
  Args a{};
  a.incl = static_cast<const int32_t*>(offsets) + 1;
  a.incl_stride = static_cast<long long>(num_rows) + 1;
  a.starts = static_cast<const int32_t*>(starts);
  a.table = static_cast<const int32_t*>(table);
  a.table_len = table_len;
  a.cols = cols;
  a.vals = static_cast<int32_t*>(vals);
  a.rows = static_cast<int32_t*>(rows);
  a.cap = capacity;
  a.num_rows = num_rows;
  a.num_blocks = capacity > 0 ? num_sources : 0;
  a.owners_div = 1;
  a.num_layers = 1;
  a.fill = fill;
  return launch(a, threads, stream);
}

}  // namespace

// Every entry takes `threads`, a CTA's threads: 128, 256 (the default) or 512.
// table (table_len, cols) int32; vals (capacity, cols); rows (capacity,).
extern "C" int csr_gather(const void* offsets, const void* starts, const void* table,
                          long long table_len, int cols, void* vals, void* rows,
                          long long capacity, int num_rows, int fill, int threads,
                          void* stream) {
  return pallas_interface(offsets, starts, table, table_len, cols, vals, rows, capacity,
                          num_rows, 1, fill, threads, stream);
}

extern "C" int csr_gather_batched(const void* offsets, const void* starts,
                                  const void* table, long long table_len, int cols,
                                  void* vals, void* rows, long long capacity, int num_rows,
                                  int num_sources, int fill, int threads, void* stream) {
  return pallas_interface(offsets, starts, table, table_len, cols, vals, rows, capacity,
                          num_rows, num_sources, fill, threads, stream);
}

// Owner side: slot_incl (D_o, D_s, R) flat inclusive sums of the slots'
// totals over the layers; starts and counts (L, D_o, D_s, R); layer_tables
// (L, 3) int64 on the device: layer l's table is (D_o, [l, 2], cols) words
// at address [l, 0] with row stride [l, 1] words; seg (D_o, D_s,
// seg_capacity, cols); dropped (D_o, D_s).
extern "C" int csr_gather_owners(const void* slot_incl, const void* starts, const void* counts,
                                 const void* layer_tables, int num_layers, int num_owners,
                                 int num_sources, int num_rows, int cols, void* seg,
                                 void* dropped, long long seg_capacity, int fill, int threads,
                                 void* stream) {
  if (num_layers < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.incl = static_cast<const int32_t*>(slot_incl);
  a.incl_stride = num_rows;
  a.starts = static_cast<const int32_t*>(starts);
  a.counts = static_cast<const int32_t*>(counts);
  a.layer_tables = static_cast<const long long*>(layer_tables);
  a.cols = cols;
  a.vals = static_cast<int32_t*>(seg);
  a.dropped = static_cast<int32_t*>(dropped);
  a.cap = seg_capacity;
  a.num_rows = num_rows;
  a.num_blocks = num_owners * num_sources;
  a.owners_div = num_sources;
  a.num_layers = num_layers;
  a.fill = fill;
  return launch(a, threads, stream);
}

// Querier side: incl (D, N) flat inclusive sums of the returned counts; starts
// (D, N) into each querier's row of table (D, table_rows, cols); vals (D,
// capacity, cols) and rows (D, capacity); offsets_out (D, N + 1) clamped to
// capacity; dropped (D,).
extern "C" int csr_gather_queriers(const void* incl, const void* starts, const void* table,
                                   long long table_rows, int cols, void* vals, void* rows,
                                   void* offsets_out, void* dropped, long long capacity,
                                   int num_rows, int num_queriers, int fill, int threads,
                                   void* stream) {
  Args a{};
  a.incl = static_cast<const int32_t*>(incl);
  a.incl_stride = num_rows;
  a.starts = static_cast<const int32_t*>(starts);
  a.table = static_cast<const int32_t*>(table);
  a.table_stride = table_rows * cols;
  a.table_len = table_rows;
  a.cols = cols;
  a.vals = static_cast<int32_t*>(vals);
  a.rows = static_cast<int32_t*>(rows);
  a.off_out = static_cast<int32_t*>(offsets_out);
  a.dropped = static_cast<int32_t*>(dropped);
  a.cap = capacity;
  a.num_rows = num_rows;
  a.num_blocks = num_queriers;
  a.owners_div = 1;
  a.num_layers = 1;
  a.fill = fill;
  return launch(a, threads, stream);
}
