// Bin-top-2 distance scan for Hopper (sm_90a): wgmma in split TF32, TMA tile
// ring, persistent warp-specialised blocks.
//
// Replaces both Pallas kernels of gpann_tpu/search/pallas_scan.py:
//   - _bintop2_blocks_kernel (line 271, called at 402 by fused_topk_blocks):
//     the serving scan;
//   - _bintop2_kernel (line 39, called at 140 by binmin_scan): brute-force
//     scan, ground truth and binned routing, which is this kernel with a
//     block table of size 1: row_off = [0], sizes = [n_valid], qb = m. Local
//     ids are then global ids.
//
// What it computes. Probe block b owns qb query rows (rows b*qb .. b*qb+qb-1
// of `queries`) and the base window [row_off[b], row_off[b] + cap). Only the
// first sizes[b] rows of the window are live; the rest count as +inf. For
// each query and each 128-row bin of the window it writes the smallest and
// second-smallest distance with their window-local row ids:
//   mins[row, bin] / argmins[row, bin]         = min1 / argmin1
//   mins[row, L + bin] / argmins[row, L + bin] = min2 / argmin2   (L = cap/128)
// Distances are L2 (|q|^2 + |x|^2 - 2 q.x) or MIPS (1 - q.x). Among equal
// computed distances the lowest id wins; argmin2 is the lowest id other than
// argmin1. A +inf entry carries the id of its bin's first row (0 in a size-0
// block); callers mask those entries.
//
// What bounds it. The work is a GEMM (2*m*n*d operations) with a top-2
// epilogue. fp32 FMA gives 67 TFLOP/s on this card; the tensor cores give
// 495 TFLOP/s in TF32, i.e. 165 TFLOP/s for a product that keeps fp32
// accuracy by three TF32 products. Against 3.35 TB/s of device memory the
// ridge is 165e12 / 3.35e12 = 49 FLOP a byte: a base tile has to meet about
// 100 query rows each time it comes from device memory, or the scan turns
// memory-bound. Inside an SM the second limit is shared memory: every wgmma
// reads its A (2 KB) and B (4 KB) slices again, 96 bytes a clock at the
// tensor peak, of the 128 the SM has.
//
// The design.
//   - Product: wgmma m64n128k8, TF32 operands, fp32 accumulators, both
//     operands K-major from shared memory (queries [., d] and base [., d] are
//     K-contiguous, so nothing is transposed). Each fp32 value x is split as
//     hi = x rounded to TF32 (nearest, ties away), lo = x - hi cut to TF32;
//     a product is lo*hi + hi*lo + hi*hi, three wgmma a k-step. The low 13
//     bits of every operand word are zero, so the result does not depend on
//     how the tensor core reads an fp32 word. One bin (128 base rows) is the
//     N of one instruction; a warpgroup owns 64 query rows.
//   - Norms |q|^2 and |x|^2 are fp32 FMA over the unsplit values
//     (|q|^2 + |x|^2 - 2 q.x cancels, so they are not taken from the split).
//   - Tiles: [128 rows x 32 dims] boxes (one 128-byte swizzle span a row)
//     loaded by TMA (128B swizzle, rows past the array and dims past d
//     zero-filled, so any d % 4 == 0 and any row count work) into a ring of
//     stages, each tracked by three mbarriers: full (TMA landed), ready
//     (split done), empty (both consumer warpgroups have finished reading).
//   - Roles: one producer warp starts the TMA loads; one converter warpgroup
//     splits each box in place (hi over the raw tile, lo beside it) and sums
//     the row norms; two consumer warpgroups start the wgmma and run the
//     epilogue. setmaxnreg moves registers from the first two to the
//     consumers, which hold two accumulator sets: the epilogue of tile t - 1
//     runs while the tensor cores work on the first box of tile t.
//   - Persistent blocks, one an SM, walk a work list of (probe block, query
//     tile of 128, range of bins). The query tile is loaded, split and
//     normed once per item and reused over the range (for d > 160 it no
//     longer fits beside the ring and travels with each base box instead).
//     Items are counted over live bins only (a prefix walk over `sizes`, no
//     atomics), query tiles fastest, so blocks running together walk one
//     base range and share it through L2. Dead bins are filled with +inf by
//     a prepass and cost nothing else.
//   - Epilogue in the accumulator's layout: a query row's 128 columns lie in
//     the 4 lanes of a quad, 32 each in ascending order; a per-thread top-2
//     with strict '<' and two xor-shuffles finish the bin.
//
// Budget at d = 96 (ptxas 12.9, sm_90a): 512 threads a block (16 warps: 8
// consumer, 4 converter, 1 producer, 3 that only hand over their registers),
// one block an SM; 128 registers a thread at launch, then 208 / 56 / 40 by
// role, 0 bytes spilled (the d > 160 instance spills 84 bytes in its main
// loop; chip_smoke.py times both instances at one size); dynamic
// shared memory 232,056 of 232,448 bytes (96 KB query tile hi + lo, 4 stages
// x 32 KB, 2.6 KB norms and barriers). The build prints ptxas's report
// (`-Xptxas -v`).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BIN = 128;             // rows per bin: semantic, decides the candidate set
constexpr int TQ = 128;              // query rows per work item: 2 warpgroups x 64
constexpr int KC = 32;               // dims per box: one 128-byte swizzle span
constexpr int BOX_BYTES = BIN * KC * 4;    // 16 KB: one [128 x 32] fp32 box
constexpr int PAIR_BYTES = 2 * BOX_BYTES;  // hi box + lo box
constexpr int CONSUMER_THREADS = 256;      // warpgroups 0 and 1
constexpr int CONVERTER_THREADS = 128;     // warpgroup 2
// + the producer's warpgroup: one warp loads, three give up their registers and leave
constexpr int THREADS = CONSUMER_THREADS + CONVERTER_THREADS + 128;
// setmaxnreg: 512 threads start with 128 registers each; the consumers take
// what the other two warpgroups give up (208 * 256 + 56 * 128 + 40 * 128 = 65,536)
constexpr int CONSUMER_REGS = 208;
constexpr int CONVERTER_REGS = 56;
constexpr int PRODUCER_REGS = 40;
constexpr int MAX_STAGES = 6;
constexpr int MAX_RESIDENT_NK = 5;   // query tile stays in shared memory up to d = 160
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block can have
constexpr long long WAIT_LIMIT = 4000000000LL;  // clocks (~2 s) before a wait traps

struct Params {
  const long long* row_off;  // [nb] first base row of each window
  const int* sizes;          // [nb] live rows of each window
  float* mins;               // [nb*qb, 2L]
  int* argmins;              // [nb*qb, 2L]
  int nb, qb, cap, L;
  int nqt;     // query tiles a probe block
  int nk;      // 32-dim boxes a row
  int rb;      // bins a work item
  int stages;  // ring depth
  int mips;
};

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase differs from `parity`. A wait that lasts
// seconds is a protocol fault: trap, so that the launch fails and does not hang.
// This assumes the process has the card to itself: where the card is
// time-sliced between processes, or a debugger holds the kernel, a healthy
// wait can outlast the limit and the trap then poisons the CUDA context.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    const long long now = clock64();
    if (t0 == 0) t0 = now;
    if (now - t0 > WAIT_LIMIT) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// generic-proxy writes to shared memory become visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// registers move from the producer and the converter to the consumers
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// K-major operand in the 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart. A k-step of 8 TF32 values is +32 bytes on the address.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d[64 x 128] (+)= a[64 x 8] * b[128 x 8]^T, TF32 in, fp32 out
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// ---- the work list ----------------------------------------------------------

// Work items are numbered over live bins only: probe block b has
// nqt * ceil(live_bins(b) / rb) of them, query tile fastest. Every role of a
// block walks the same items j = blockIdx.x, + gridDim.x, ... with a cursor
// that moves forward over the probe blocks.
struct Cursor {
  int b = 0;            // probe block the cursor stands on
  long long first = 0;  // number of its first item
  int size = 0;         // its live rows, clamped to [0, cap]
  int nr = 0;           // its bin ranges
};

__device__ __forceinline__ int live_rows(const Params& p, int b) {
  return min(max(__ldg(p.sizes + b), 0), p.cap);
}

__device__ __forceinline__ void cursor_load(const Params& p, Cursor& c) {
  if (c.b < p.nb) {
    c.size = live_rows(p, c.b);
    const int lb = (c.size + BIN - 1) / BIN;
    c.nr = (lb + p.rb - 1) / p.rb;
  }
}

struct Item {
  int b, qt, bin0, bin1, size;
};

__device__ __forceinline__ bool cursor_seek(const Params& p, Cursor& c, long long j, Item& it) {
  for (;;) {
    if (c.b >= p.nb) return false;
    const long long items = static_cast<long long>(p.nqt) * c.nr;
    if (j < c.first + items) break;
    c.first += items;
    ++c.b;
    cursor_load(p, c);
  }
  const int local = static_cast<int>(j - c.first);
  const int range = local / p.nqt;
  it.b = c.b;
  it.qt = local - range * p.nqt;
  it.size = c.size;
  it.bin0 = range * p.rb;
  it.bin1 = min(it.bin0 + p.rb, (c.size + BIN - 1) / BIN);
  return true;
}

struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---- converter: split one [128 x 32] box, one row a thread -------------------

// Reads the raw fp32 row `t` of the box at `box`, writes hi over it and lo
// into the box BOX_BYTES further, and adds the row's squares to `nrm` in
// ascending dim order. Chunk c of row t sits at chunk c ^ (t % 8).
__device__ __forceinline__ void split_row(char* box, int t, float& nrm) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float4* p = reinterpret_cast<float4*>(box + t * 128 + ((c ^ (t & 7)) << 4));
    const float4 x = *p;
    const float xs[4] = {x.x, x.y, x.z, x.w};
    float hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      nrm = fmaf(xs[e], xs[e], nrm);
      // nearest TF32 (10-bit mantissa), ties away from zero
      hi[e] = __uint_as_float((__float_as_uint(xs[e]) + 0x1000u) & 0xFFFFE000u);
      lo[e] = __uint_as_float(__float_as_uint(xs[e] - hi[e]) & 0xFFFFE000u);
    }
    *p = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(reinterpret_cast<char*>(p) + BOX_BYTES) =
        make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// ---- the kernel ---------------------------------------------------------------

// STREAM_Q = false: the query tile (hi and lo, all of d) stays in shared
// memory for a whole work item. STREAM_Q = true (large d): each stage carries
// the query box beside the base box.
template <bool STREAM_Q>
__global__ void __launch_bounds__(THREADS, 1)
bintop2_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap base_map, const Params p) {
  extern __shared__ __align__(1024) char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int L = p.L;
  const long long ld_out = 2LL * L;

  // shared memory: [query tile][ring][bias][qsq][barriers]
  const int stage_bytes = STREAM_Q ? 2 * PAIR_BYTES : PAIR_BYTES;
  char* q_region = smem;
  char* ring_mem = smem + (STREAM_Q ? 0 : p.nk * PAIR_BYTES);
  float* bias = reinterpret_cast<float*>(ring_mem + p.stages * stage_bytes);  // [stages][128]
  float* qsq = bias + p.stages * BIN;  // [128], or [stages][128] when streaming
  uint64_t* bars = reinterpret_cast<uint64_t*>(qsq + (STREAM_Q ? p.stages : 1) * TQ);
  const uint32_t bar0 = smem_u32(bars);
  // barrier s of kind k (0 full, 1 ready, 2 empty); then q_full, q_ready, q_empty
  auto bar = [&](int kind, int s) { return bar0 + 8u * (kind * p.stages + s); };
  const uint32_t q_full = bar0 + 8u * (3 * p.stages);
  const uint32_t q_ready = q_full + 8, q_empty = q_full + 16;

  if (tid == 0) {
    if (smem_u32(smem) & 1023) __trap();  // the swizzle needs 1024-byte alignment
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), CONVERTER_THREADS);
      mbar_init(bar(2, s), CONSUMER_THREADS / 32);
    }
    mbar_init(q_full, 1);
    mbar_init(q_ready, CONVERTER_THREADS);
    mbar_init(q_empty, CONSUMER_THREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // prepass: +inf into every bin past a window's live rows
  {
    const long long rows = static_cast<long long>(p.nb) * p.qb;
    const long long warps = static_cast<long long>(gridDim.x) * (THREADS / 32);
    for (long long r = static_cast<long long>(blockIdx.x) * (THREADS / 32) + (tid >> 5);
         r < rows; r += warps) {
      const int size = live_rows(p, static_cast<int>(r / p.qb));
      for (int bin = (size + BIN - 1) / BIN + lane; bin < L; bin += 32) {
        const long long o = r * ld_out + bin;
        const int id = size == 0 ? 0 : bin * BIN;
        p.mins[o] = CUDART_INF_F;
        p.mins[o + L] = CUDART_INF_F;
        p.argmins[o] = id;
        p.argmins[o + L] = id;
      }
    }
  }
  __syncthreads();

  Cursor cur;
  cursor_load(p, cur);
  Item it;
  Ring ring;
  uint32_t q_phase = 0;  // flips once a work item

  if (tid >= CONSUMER_THREADS + CONVERTER_THREADS) {
    // ===== producer warp: one lane starts every TMA load =====
    reg_dealloc<PRODUCER_REGS>();
    if (tid != CONSUMER_THREADS + CONVERTER_THREADS) return;
    for (long long j = blockIdx.x; cursor_seek(p, cur, j, it); j += gridDim.x) {
      const int q_row = it.b * p.qb + it.qt * TQ;
      const long long w_row = __ldg(p.row_off + it.b);
      if (!STREAM_Q) {
        mbar_wait(q_empty, q_phase ^ 1);
        mbar_expect_tx(q_full, p.nk * BOX_BYTES);
        for (int kc = 0; kc < p.nk; ++kc)
          tma_load_2d(smem_u32(q_region + kc * PAIR_BYTES), &q_map, q_full, kc * KC, q_row);
        q_phase ^= 1;
      }
      for (int bin = it.bin0; bin < it.bin1; ++bin) {
        const int row = static_cast<int>(w_row + static_cast<long long>(bin) * BIN);
        for (int kc = 0; kc < p.nk; ++kc) {
          mbar_wait(bar(2, ring.stage), ring.phase ^ 1);
          const uint32_t dst = smem_u32(ring_mem + ring.stage * stage_bytes);
          mbar_expect_tx(bar(0, ring.stage), STREAM_Q ? 2 * BOX_BYTES : BOX_BYTES);
          tma_load_2d(dst, &base_map, bar(0, ring.stage), kc * KC, row);
          if (STREAM_Q)
            tma_load_2d(dst + PAIR_BYTES, &q_map, bar(0, ring.stage), kc * KC, q_row);
          ring.advance(p.stages);
        }
      }
    }
  } else if (tid >= CONSUMER_THREADS) {
    // ===== converter warpgroup: thread t splits row t of every box =====
    reg_dealloc<CONVERTER_REGS>();
    const int t = tid - CONSUMER_THREADS;
    for (long long j = blockIdx.x; cursor_seek(p, cur, j, it); j += gridDim.x) {
      if (!STREAM_Q) {
        mbar_wait(q_full, q_phase);
        float nq = 0.f;
        for (int kc = 0; kc < p.nk; ++kc) split_row(q_region + kc * PAIR_BYTES, t, nq);
        qsq[t] = nq;
        fence_proxy_async();
        mbar_arrive(q_ready);
        q_phase ^= 1;
      }
      for (int bin = it.bin0; bin < it.bin1; ++bin) {
        float nx = 0.f, nq = 0.f;
        for (int kc = 0; kc < p.nk; ++kc) {
          mbar_wait(bar(0, ring.stage), ring.phase);
          char* stage = ring_mem + ring.stage * stage_bytes;
          split_row(stage, t, nx);
          if (STREAM_Q) split_row(stage + PAIR_BYTES, t, nq);
          if (kc == p.nk - 1) {
            // the epilogue adds bias[col]: |x|^2 (L2), 0 (MIPS), +inf (dead row)
            const bool live = bin * BIN + t < it.size;
            bias[ring.stage * BIN + t] = live ? (p.mips ? 0.f : nx) : CUDART_INF_F;
            if (STREAM_Q) qsq[ring.stage * TQ + t] = nq;
          }
          fence_proxy_async();
          mbar_arrive(bar(1, ring.stage));
          ring.advance(p.stages);
        }
      }
    }
  } else {
    // ===== consumer warpgroups: wgmma and the top-2 epilogue =====
    reg_alloc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int quad = lane & 3;
    const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);  // rows r0 and r0 + 8
    const float scale = p.mips ? -1.f : -2.f;
    // Two accumulator sets: the epilogue of tile t - 1 runs while the tensor
    // cores work on the first box of tile t (both warpgroups queue one, about
    // an epilogue's worth of work). One box is in flight behind the newest
    // one; `held` is the last box of the tile whose epilogue is still to
    // run: its stage carries the tile's biases and is released after it.
    float acc0[64], acc1[64];
    float qt0 = 1.f, qt1 = 1.f;  // the query rows' terms: |q|^2 (L2) or 1 (MIPS)
    int prev = 0;                // stage of the box committed before this one
    int held = 0;
    int held_bin = 0;            // its bin (the tile belongs to the current item)

    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(2, stage));
    };
    // the held tile, in `acc`: top-2 of the thread's two rows over its 32
    // columns, merged over the quad, stored
    auto epilogue = [&](float (&acc)[64]) {
      const int bin = held_bin;
      float bs[32];  // biases of the thread's 32 columns
      {
        const float2* b2 = reinterpret_cast<const float2*>(bias + held * BIN + 2 * quad);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const float2 v = b2[4 * jj];
          bs[2 * jj] = v.x;
          bs[2 * jj + 1] = v.y;
        }
      }
      if (STREAM_Q && !p.mips) {
        qt0 = qsq[held * TQ + r0];
        qt1 = qsq[held * TQ + r0 + 8];
      }
      const int qrow = it.qt * TQ + r0;  // within the probe block
      const long long out0 = (static_cast<long long>(it.b) * p.qb + qrow) * ld_out;
      float v1[2] = {CUDART_INF_F, CUDART_INF_F}, v2[2] = {CUDART_INF_F, CUDART_INF_F};
      int i1[2] = {0, 0}, i2[2] = {0, 0};
      // columns 8 * (c / 2) + 2 * quad + c % 2, ascending; strict '<' keeps the lowest id
#pragma unroll
      for (int c = 0; c < 32; ++c) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = fmaf(scale, acc[4 * (c >> 1) + 2 * h + (c & 1)],
                               (h ? qt1 : qt0) + bs[c]);
          const bool lt1 = v < v1[h], lt2 = v < v2[h];
          i2[h] = lt1 ? i1[h] : (lt2 ? c : i2[h]);
          v2[h] = lt1 ? v1[h] : fminf(v, v2[h]);
          i1[h] = lt1 ? c : i1[h];
          v1[h] = fminf(v, v1[h]);
        }
      }
      const int row0 = bin * BIN;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // local column index -> window row id
        int a1 = row0 + 8 * (i1[h] >> 1) + 2 * quad + (i1[h] & 1);
        int a2 = row0 + 8 * (i2[h] >> 1) + 2 * quad + (i2[h] & 1);
        float m1 = v1[h], m2 = v2[h];
        // merge over the quad; (value, id) order keeps the lowest id on ties
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float o1 = __shfl_xor_sync(0xffffffffu, m1, off);
          const int oa1 = __shfl_xor_sync(0xffffffffu, a1, off);
          const float o2 = __shfl_xor_sync(0xffffffffu, m2, off);
          const int oa2 = __shfl_xor_sync(0xffffffffu, a2, off);
          const bool mine = m1 < o1 || (m1 == o1 && a1 < oa1);
          // winner w, loser l of the two firsts; second = best of (w's second, l's first)
          const float w1 = mine ? m1 : o1, l1 = mine ? o1 : m1;
          const int wa1 = mine ? a1 : oa1, la1 = mine ? oa1 : a1;
          const float w2 = mine ? m2 : o2;
          const int wa2 = mine ? a2 : oa2;
          const bool sec = w2 < l1 || (w2 == l1 && wa2 < la1);
          m1 = w1;
          a1 = wa1;
          m2 = sec ? w2 : l1;
          a2 = sec ? wa2 : la1;
        }
        if (m1 == CUDART_INF_F) a1 = row0;
        if (m2 == CUDART_INF_F) a2 = row0;
        if (quad == h && qrow + 8 * h < p.qb) {
          const long long o = out0 + 8 * h * ld_out + bin;
          p.mins[o] = m1;
          p.mins[o + L] = m2;
          p.argmins[o] = a1;
          p.argmins[o + L] = a2;
        }
      }
    };

    // wgmma of one box of the current tile into `acc`
    auto mma_box = [&](float (&acc)[64], int kc) {
      mbar_wait(bar(1, ring.stage), ring.phase);
      const uint32_t b_addr = smem_u32(ring_mem + ring.stage * stage_bytes);
      const uint32_t a_addr =
          (STREAM_Q ? b_addr + PAIR_BYTES : smem_u32(q_region + kc * PAIR_BYTES)) +
          wg * 64 * 128;
      const uint64_t a_hi = smem_desc(a_addr), b_hi = smem_desc(b_addr);
      const uint64_t a_lo = a_hi + (BOX_BYTES >> 4), b_lo = b_hi + (BOX_BYTES >> 4);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        const uint64_t off = 2 * ks;  // 32 bytes, in 16-byte units
        wgmma_m64n128k8(acc, a_lo + off, b_hi + off, (kc | ks) != 0);
        wgmma_m64n128k8(acc, a_hi + off, b_lo + off, 1);
        wgmma_m64n128k8(acc, a_hi + off, b_hi + off, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the box before this one is complete
    };
    // Start tile `bin` in `acc`; once its first box is committed, run the
    // epilogue of the held tile from `other` (has_prev is a literal).
    auto do_tile = [&](float (&acc)[64], float (&other)[64], int bin, const bool has_prev) {
      mma_box(acc, 0);
      if (has_prev) {
        epilogue(other);
        release(held);
      }
      prev = ring.stage;
      ring.advance(p.stages);
      for (int kc = 1; kc < p.nk; ++kc) {
        mma_box(acc, kc);
        release(prev);
        prev = ring.stage;
        ring.advance(p.stages);
      }
      held = prev;
      held_bin = bin;
    };
    auto last_epilogue = [&](float (&acc)[64]) {
      wgmma_wait<0>();
      epilogue(acc);
      release(held);
    };

    for (long long j = blockIdx.x; cursor_seek(p, cur, j, it); j += gridDim.x) {
      if (!STREAM_Q) {
        mbar_wait(q_ready, q_phase);
        q_phase ^= 1;
        qt0 = p.mips ? 1.f : qsq[r0];
        qt1 = p.mips ? 1.f : qsq[r0 + 8];
      }
      int bin = it.bin0;
      do_tile(acc0, acc1, bin++, false);
      while (bin + 1 < it.bin1) {  // the held tile is in acc0
        do_tile(acc1, acc0, bin++, true);
        do_tile(acc0, acc1, bin++, true);
      }
      if (bin < it.bin1) {
        do_tile(acc1, acc0, bin, true);
        last_epilogue(acc1);
      } else {
        last_epilogue(acc0);
      }
      if (!STREAM_Q) {  // every wgmma of the item has read the query tile
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty);
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (libcuda) fn = reinterpret_cast<EncodeTiled>(dlsym(libcuda, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// [rows, d] fp32, row-major, as [128 rows x 32 dims] boxes in the 128-byte swizzle
int make_map(CUtensorMap* map, const float* ptr, long long rows, int d) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return -1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {KC, BIN};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                              const_cast<float*>(ptr), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -2 - static_cast<int>(res);
}

template <bool STREAM_Q>
int launch(const CUtensorMap& q_map, const CUtensorMap& base_map, const Params& p, int grid,
           int smem_bytes, cudaStream_t s) {
  // setmaxnreg moves registers inside the block's allocation: the block must
  // have been given enough for the three roles, or a consumer would wait forever
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, bintop2_kernel<STREAM_Q>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * THREADS < CONSUMER_REGS * CONSUMER_THREADS +
                                   CONVERTER_REGS * CONVERTER_THREADS + PRODUCER_REGS * 128)
    return -1000 - attr.numRegs;
  err = cudaFuncSetAttribute(bintop2_kernel<STREAM_Q>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bintop2_kernel<STREAM_Q><<<grid, THREADS, smem_bytes, s>>>(q_map, base_map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, does not
// synchronise, allocates nothing. Returns 0, a CUDA runtime error (> 0), or
// < 0 when a tensor map could not be encoded (-1: libcuda has no cuTensorMapEncodeTiled,
// -2 - CUresult otherwise) or the build gave the kernel too few registers
// for its roles (-1000 - registers).
// The caller checks: cap % 128 == 0; d % 4 == 0; both pointers 16-byte
// aligned; base_rows >= 1; base_rows + cap < 2^31; nb * qb < 2^31.
extern "C" int bintop2_blocks(const float* queries, const float* base,
                              const long long* row_off, const int* sizes, float* mins,
                              int* argmins, int nb, int qb, int cap, int d, long long base_rows,
                              int mips, void* stream) {
  Params p;
  p.row_off = row_off;
  p.sizes = sizes;
  p.mins = mins;
  p.argmins = argmins;
  p.nb = nb;
  p.qb = qb;
  p.cap = cap;
  p.L = cap / BIN;
  p.nqt = (qb + TQ - 1) / TQ;
  p.nk = (d + KC - 1) / KC;
  p.mips = mips;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  // bins a work item: long enough to amortise the query tile, short enough
  // that every SM gets several items
  const long long tiles = static_cast<long long>(nb) * p.nqt * p.L;
  long long rb = (tiles + 8LL * sms - 1) / (8LL * sms);
  p.rb = static_cast<int>(rb < 1 ? 1 : (rb > 64 ? 64 : rb));
  const long long items = static_cast<long long>(nb) * p.nqt * ((p.L + p.rb - 1) / p.rb);
  const int grid = static_cast<int>(items < sms ? items : sms);

  const bool stream_q = p.nk > MAX_RESIDENT_NK;
  const int stage_bytes = stream_q ? 2 * PAIR_BYTES : PAIR_BYTES;
  const int q_bytes = stream_q ? 0 : p.nk * PAIR_BYTES;
  // a stage costs its boxes, its bias row, (streaming) its norm row, 3 barriers
  const int per_stage = stage_bytes + BIN * 4 + (stream_q ? TQ * 4 : 0) + 24;
  const int fixed = q_bytes + (stream_q ? 0 : TQ * 4) + 24;
  int stages = (SMEM_LIMIT - fixed) / per_stage;
  p.stages = stages > MAX_STAGES ? MAX_STAGES : stages;
  const int smem_bytes = fixed + p.stages * per_stage;

  CUtensorMap q_map, base_map;
  int res = make_map(&q_map, queries, static_cast<long long>(nb) * qb, d);
  if (res == 0) res = make_map(&base_map, base, base_rows, d);
  if (res != 0) return res;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stream_q ? launch<true>(q_map, base_map, p, grid, smem_bytes, s)
                  : launch<false>(q_map, base_map, p, grid, smem_bytes, s);
}
