"""Two other designs of K4's dense pass (csrc/hamming.cu), as edits of the
committed source, for ``tools/hamming_tuning.py --dense --swap NAME``.

``staged b``: B's column tiles reach the warps through shared memory, by
``cp.async`` (8-byte copies: B is only 8-byte aligned), double-buffered as
in the min cross-bag pass: a stage is ``kAhead`` tiles a warp (the tiles
the committed loop keeps in registers), the block's 128 threads copy it
together and load its columns' flags, and the next stage is in flight while
the warps reduce this one.  The committed loop loads each warp's columns
straight from global memory into registers, ``kAhead`` tiles a warp ahead.

``ticket``: the merge across column chunks runs in the last block of each
row block to arrive (a ticket counter, an integer ``atomicAdd`` after a
fence; the last block resets it) in place of the second launch,
``hamming_bmma_merge_kernel``: a warp a row over the chunks' keys, as that
kernel does.  The counters are a ``__device__`` array, zero when the
library loads.

Each edit is (begin, end, text): the source from the start of ``begin`` up
to the start of ``end`` is replaced by ``text`` (``begin`` equal to ``end``
inserts ``text`` there); each marker must be in the source once.  Both
variants keep the launchers' C interface, so ``ops/hamming_kernel.bind``
binds them as it binds the committed library.
"""

from __future__ import annotations

STAGED_B_LOOP = r"""  // B's column tiles staged in shared memory by cp.async, double-buffered:
  // a stage is kAhead tiles a warp (8-byte copies: B is 8-byte aligned),
  // its columns' flags beside it
  constexpr int kAhead = kStore ? kStoreAhead : kDenseAhead;
  constexpr int kStage = kAhead * kDenseWarps;                 // column tiles a stage
  constexpr int kCopies = kStage * 8 * 4 / kDenseThreads;      // 8-byte copies a thread
  static_assert(kStage * 8 <= kDenseThreads, "a thread a column's flag");
  __shared__ uint2 s_b[2][kStage * 8 * 4];
  __shared__ bool s_ok[2][kStage * 8];
  const int col_end = tile1 * 8 < M ? tile1 * 8 : M;
  const int stages = (tile1 - tile0 + kStage - 1) / kStage;
  bool ok_reg = false;
  {
    const int c0 = tile0 * 8;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      const int i = threadIdx.x + k * kDenseThreads, col = c0 + i / 4;
      if (col < col_end) __pipeline_memcpy_async(&s_b[0][i], b + (s * M + col) * 4 + i % 4, 8);
    }
    __pipeline_commit();
    const int col = c0 + static_cast<int>(threadIdx.x);
    ok_reg = threadIdx.x < kStage * 8 && col < col_end &&
             (col_ok == nullptr || col_ok[s * M + col]);
  }
  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    if (threadIdx.x < kStage * 8) s_ok[buf][threadIdx.x] = ok_reg;
    if (st + 1 < stages) {
      const int c0 = (tile0 + (st + 1) * kStage) * 8;
#pragma unroll
      for (int k = 0; k < kCopies; ++k) {
        const int i = threadIdx.x + k * kDenseThreads, col = c0 + i / 4;
        if (col < col_end)
          __pipeline_memcpy_async(&s_b[buf ^ 1][i], b + (s * M + col) * 4 + i % 4, 8);
      }
      __pipeline_commit();
      const int col = c0 + static_cast<int>(threadIdx.x);
      ok_reg = threadIdx.x < kStage * 8 && col < col_end &&
               (col_ok == nullptr || col_ok[s * M + col]);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int lt = warp + u * kDenseWarps, tl = tile0 + st * kStage + lt;
      if (tl >= tile1) break;                 // the same for the whole warp
      ColumnWords c{make_uint2(0u, 0u), false};
      if (tl * 8 + group < M) {
        c.w = s_b[buf][(lt * 8 + group) * 4 + t];
        c.ok = s_ok[buf][lt * 8 + group];
      }
      const TileKeys k = tile_keys<kStore>(c, tl, tile0, M, group, t);
      const unsigned(&fb)[2] = k.fb;
      const int lo = k.lo, hi = k.hi;
      const int m = tl * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int d[4];
        mma_and_popc(d, fa[r], fb, zero);
        if (kStore) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = n0 + 16 * r + group + 8 * h;
            if (n >= N) continue;
            const int v0 = pa[r][h] + lo - 2 * d[2 * h], v1 = pa[r][h] + hi - 2 * d[2 * h + 1];
            int* o = out + (s * N + n) * static_cast<long long>(M) + m;
            if (pairs && m + 1 < M) {
              *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
            } else {
              if (m < M) o[0] = v0;
              if (m + 1 < M) o[1] = v1;
            }
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            take(kb[r][h], ks[r][h],
                 static_cast<unsigned>(lo) - (static_cast<unsigned>(d[2 * h]) << (kKeyShift + 1)));
            take(kb[r][h], ks[r][h],
                 static_cast<unsigned>(hi) -
                     (static_cast<unsigned>(d[2 * h + 1]) << (kKeyShift + 1)));
          }
        }
      }
    }
    __syncthreads();                          // the stage read by every warp
  }
"""

TICKET_MERGE_ROW = r"""// The ticket's counters, a row block of a row s each (zero at load; the
// last block to arrive resets its own).
constexpr int kTickets = 1 << 16;
__device__ unsigned g_tickets[kTickets];

// Row `row`'s best two from its chunks' keys (a warp; the loads past the
// L1, which may hold none of another block's writes).
__device__ __forceinline__ void merge_row(const bool* row_ok, const unsigned long long* part_key,
                                          const unsigned* part_second, long long row,
                                          int chunks, int M, float big, float* best,
                                          float* second, long long* idx, int lane) {
  unsigned long long bk = ~0ull;
  unsigned sv = kNoKey;
  const unsigned long long* keys = part_key + row * chunks;
  const unsigned* seconds = part_second + row * chunks;
  for (int c0 = lane; c0 < chunks; c0 += 32 * kMergeLoads) {
    unsigned long long k[kMergeLoads];
    unsigned v[kMergeLoads];
#pragma unroll
    for (int u = 0; u < kMergeLoads; ++u) {
      const int c = c0 + 32 * u;
      k[u] = c < chunks ? __ldcg(keys + c) : ~0ull;
      v[u] = c < chunks ? __ldcg(seconds + c) : kNoKey;
    }
#pragma unroll
    for (int u = 0; u < kMergeLoads; ++u) {
      sv = umin(umin(sv, v[u]), static_cast<unsigned>(umax64(bk, k[u]) >> 32));
      bk = umin64(bk, k[u]);
    }
  }
  for (int lane_mask = 16; lane_mask >= 1; lane_mask /= 2) {
    const unsigned long long ok = __shfl_xor_sync(0xFFFFFFFFu, bk, lane_mask);
    const unsigned os = __shfl_xor_sync(0xFFFFFFFFu, sv, lane_mask);
    sv = umin(umin(sv, os), static_cast<unsigned>(umax64(bk, ok) >> 32));
    bk = umin64(bk, ok);
  }
  if (lane == 0)
    write_best_two(row_ok[row], M, static_cast<unsigned>(bk >> 32), static_cast<unsigned>(bk), sv,
                   big, best + row, second + row, idx + row);
}

"""

TICKET_TAIL = r"""  if (part_key == nullptr) return;
  // the last block of this row block to arrive merges its chunks
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* ticket = g_tickets + (s * gridDim.y + blockIdx.y) % kTickets;
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (s_last) *ticket = 0u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int rows = N - n0 < 16 * R ? N - n0 : 16 * R;
#pragma unroll 4
  for (int i = warp; i < rows; i += kDenseWarps)
    merge_row(row_ok, part_key, part_second, s * N + n0 + i, gridDim.x, M, big, best, second,
              idx, lane);
"""

TICKET_LAUNCH_END = r"""  return static_cast<int>(cudaGetLastError());
}

"""

LOOP_BEGIN = "  // B's column tiles: the lane's words of column group of the warp's next\n"
LOOP_END = "  if (kStore) return;\n"
KERNEL = "// a [S, N, 8] and b [S, M, 8] as uint2 (words 2t, 2t + 1 of a descriptor at\n"
KERNEL_END = "}\n\n// The chunks' best two of each row (part_key, part_second [S, N, chunks])\n"
MERGE_LAUNCH = "  e = static_cast<int>(cudaGetLastError());\n  if (e != 0 || !merge) return e;\n"
MATRIX_LAUNCHER = "// out [S, N, M] int32 from a [S, N, 8], b [S, M, 8] (8-byte aligned) on\n"

# name -> ((begin, end, text), ...)
VARIANTS = {
    "staged b": ((LOOP_BEGIN, LOOP_END, STAGED_B_LOOP),),
    "ticket": ((KERNEL, KERNEL, TICKET_MERGE_ROW), (KERNEL_END, KERNEL_END, TICKET_TAIL),
               (MERGE_LAUNCH, MATRIX_LAUNCHER, TICKET_LAUNCH_END)),
}


def edited(src: str, names) -> str:
    """``src`` with the edits of each variant in ``names``; raises where a
    marker is not in the source once."""
    for name in names:
        for begin, end, text in VARIANTS[name]:
            for marker in {begin, end}:
                if src.count(marker) != 1:
                    raise ValueError(f"{name}: the marker is not in the source once: {marker!r}")
            i, j = src.index(begin), src.index(end)
            if j < i:
                raise ValueError(f"{name}: the markers are out of order")
            src = src[:i] + text + src[j:]
    return src
