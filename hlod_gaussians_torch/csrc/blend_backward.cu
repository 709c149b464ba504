// Kernel B2: per-tile back-to-front blend backward (per-entry gradients).
//
// Replaces: hlod_gaussians_tpu/ops/rasterize_pallas.py::blend_backward
// (_backward_kernel/_backward_tile and _backward_kernel_il, shared math
// _chunk_alpha). Plain version: hlod_gaussians_torch/ops/rasterize_xla.py
// ::blend_backward_plain. Wrapper: hlod_gaussians_torch/ops/rasterize_cuda.py.
//
// What it computes, per tile, walking the tile's depth-sorted entries back
// to front from the largest n_contrib of its pixels:
//   an entry k is applied at a pixel iff it passes the forward's skips
//   (power <= 0, alpha >= alpha_min) and k + 1 <= n_contrib, which is
//   exactly the set kernel B1 applied; T before it is rebuilt by division,
//   T_k = T_{k+1} / (1 - alpha_k), starting from final_t;
//   dL/dalpha = cdotg * T_k - (S + g_T * final_t) / (1 - alpha_k), with
//   cdotg = sum_ch c_ch g_ch and the suffix S = sum_{j>k} alpha_j T_j cdotg_j;
//   the LOD chain rule multiplies by dalpha/dmy; where op*G >= 0.99 (the
//   clip) power and opacity get no gradient. Per entry it writes one row of
//   egrads [max_dup, 12]: dgx, dgy, d(s0, s1, s2), dop, drgb, dinvdepth;
//   columns 10 and 11 (t and 1/kids) carry no gradient and stay zero.
//
// Bound on this card: operations. Per needed (entry, pixel) pair, i.e. each
// entry before the pixel's n_contrib, about 14 f32 operations decide whether
// it was applied, and about 24 more follow for an applied pair, against 48
// bytes of features per entry and 28 bytes of per-pixel inputs. What the
// bound does not count: every entry belongs to one tile, so its gradient is
// a sum over the tile's pixels (ten sums per entry), the walk runs in
// whole warps, and the entry batches are shared by the block. On an H100 at
// the 1080p bench frame the decision walk alone takes about two thirds of
// the kernel's time (scripts/b2_variants.py).
//
// Design (one block per tile):
// - P pixels per thread, P the largest of 4, 2, 1 that tiles the tile into
//   warp patches (launch_shape; 256 threads at 32x32 and 8x128 tiles). A
//   warp owns a compact pw x 32*P/pw patch (16x8 at 32x32), and a lane
//   takes P pixels of one patch row, so the dy terms of power are computed
//   once for P pixels (in B1's operation order). Each thread carries P
//   independent (T, S) chains and adds its P pixels' ten contributions in
//   registers, so the warp reduction is paid once per 32*P pixels, and is
//   skipped (__any_sync) where no lane applied the entry.
// - A transposing (reduce-scatter) butterfly: at each xor level a lane keeps
//   half of its values and sends the other half, 10 -> 5 -> 3 -> 2 -> 1 ->
//   1 values, 12 shuffles per (entry, warp) in place of 10 x 5 = 50; the ten
//   sums end in ten lanes, which store them with one instruction.
// - Less walking: a warp skips the entries at or past its pixels' largest
//   n_contrib (whole batches, too) without storing anything, and the
//   cross-warp sum reads a warp's partial only where that warp walked the
//   entry; on the flat path a pixel whose power lies below log(alpha_min /
//   opacity) - 0.05 skips the exp (op * exp(power) < 0.95 alpha_min there,
//   so B1 did not apply it either). The P powers are computed straight-line
//   first, and a warp none of whose pixels passes the power tests leaves
//   the entry after one vote.
// - Entries go through shared memory in batches of kBatch, in a ring of
//   kStages feature slots filled by warp 0 with 16-byte cp.async (the
//   sorted_gid load for the batch after next is in flight in a register).
//   One __syncthreads per batch: after it, batch i is resident, batch i-1's
//   partials are complete and the slot of batch i-2 is free; then batch i+1
//   is issued, batch i-1 is summed across warps and written out (ten lanes
//   per entry, three entries per warp instruction), and batch i is walked.
//   Partials are double-buffered by batch parity.
// - Occupancy: three blocks of 256 threads per SM at P = 4 (80 registers);
//   two or four measure slower (scripts/b2_variants.py).
// - Determinism: no atomics; every sum runs in a fixed order (the P pixels,
//   the butterfly tree, the warps in index order), so two launches on the
//   same inputs give the same bits. The summation order differs from the
//   plain version's, so results agree to rounding, not bitwise.
// - The decision arithmetic (power, LOD alpha) uses the _rn intrinsics
//   exactly as blend_forward.cu does, so both kernels and the plain version
//   agree on the applied set; the T rebuild uses IEEE division (the suffix
//   term S / (1 - alpha), a gradient and no decision, a 2-ulp divide).
//   Build without --use_fast_math.
// - Tensor cores: not used. The ten sums are [entries x pixels] x [pixels x
//   10] products, but their operands (dpower, contrib) are made per pair by
//   the serial walk itself, and TF32 would carry ~1e-3 relative error
//   against the 3e-4 scaled tolerance; the moment form (sums of dpower
//   times 1, px, py, px^2, px*py, py^2) cancels badly at pixel coordinates
//   near 1920. The reduction is ~10% of the time at the bench frame
//   (b2_variants.py), so there is little for them to take.
//
// Budget per block (threads = tile_w*tile_h/P, W = threads/32 warps):
// shared memory kStages*kBatch*48 B of features (4.6 KB) plus 2*kBatch*W*10
// floats of partials: P = 4 at 32x32: 256 threads, 25.1 KB; P = 2 (e.g.
// 8x8): 32 threads, 7.2 KB; P = 1 (at most 992 threads, 31 warps): 84 KB.
// Registers: __launch_bounds__ asks for three blocks of 256 per SM at P = 4
// flat (at most 85 registers a thread; ptxas uses 80 and spills 4 bytes)
// and two with LOD (at most 128), one block at P = 2 (128) and P = 1 (64).
// The per-thread state is 7*P + 1 registers (T, S, four cotangents and
// n_contrib per pixel, px per pixel, one py). The ptxas lines that
// chip_smoke.py prints give the real counts.
//
// scripts/b2_variants.py times this source against edited copies of it (P
// capped, plain butterflies, other occupancy and batch sizes).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 4;     // pixels per thread, at most
constexpr int kBatch = 32;   // entries per shared-memory batch
constexpr int kStages = 3;   // feature slots: walked, written out, in flight
constexpr int kSums = 10;    // pixel sums reduced per entry
constexpr int kCols = 12;    // egrads columns
constexpr unsigned kFull = 0xffffffffu;

// Sum order (= egrads column, with su/sv turned into dgx/dgy and dpower into
// dop at write-out): su, sv, dx*u, dy*u, dy*v, dpower, contrib * g0..g3.

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float shfl(float x, int o) {
  return __shfl_xor_sync(kFull, x, o);
}

// Reduce-scatter of v[0..9] over the warp: returns the warp-wide sum of
// value *c in the lane that stores it, *c = -1 in the other lanes. Level by
// level (xor 16, 8, 4, 2, 1) a lane's values halve, 10 -> 5 -> {3|2} ->
// {2|1} -> 1; partners always hold the same set of value indices.
__device__ __forceinline__ float reduce_scatter10(const float (&v)[kSums],
                                                  int lane, int* c) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float w[5];                            // b4 clear: values 0-4, set: 5-9
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const float send = b4 ? v[s] : v[s + 5];
    const float keep = b4 ? v[s + 5] : v[s];
    w[s] = keep + shfl(send, 16);
  }
  // b3 clear keeps slots 0-2 (x0..x2), set keeps slots 3-4 (x0, x1)
  const float x0 = (b3 ? w[3] : w[0]) + shfl(b3 ? w[0] : w[3], 8);
  const float x1 = (b3 ? w[4] : w[1]) + shfl(b3 ? w[1] : w[4], 8);
  const float x2 = w[2] + shfl(w[2], 8);               // b3 clear only
  // b3 clear: {x0, x1} (b2 clear) / {x2} (b2 set); b3 set: {x0} / {x1}
  const float other = b3 ? x1 : x2;
  const float y0 = (b2 ? other : x0) + shfl(b2 ? x0 : other, 4);
  const float y1 = x1 + shfl(x1, 4);                   // b3, b2 clear only
  // b3, b2 clear: {y0} (b1 clear) / {y1} (b1 set); the rest hold one value
  const bool two = !b3 && !b2;
  const float z0 = (two && b1 ? y1 : y0) + shfl(two && !b1 ? y1 : y0, 2);
  const float z = z0 + shfl(z0, 1);
  const int idx = (b4 ? 5 : 0) + (b3 ? 3 + (b2 ? 1 : 0)
                                     : (b2 ? 2 : (b1 ? 1 : 0)));
  *c = (!(lane & 1) && (two || !b1)) ? idx : -1;
  return z;
}

// Blocks per SM asked of ptxas: at P = 4 three blocks of 256 threads (80
// registers) for the flat kernel, two for the LOD one, which would spill
template <bool LOD, int P>
struct Bounds {
  static constexpr int kThreads = 1024 / P;
  static constexpr int kMinBlocks = P == 4 ? (LOD ? 2 : 3) : 1;
};

template <bool LOD, int P>
__global__ void __launch_bounds__(Bounds<LOD, P>::kThreads,
                                  Bounds<LOD, P>::kMinBlocks)
blend_backward_kernel(const float4* __restrict__ feats,    // [N, 3] float4
                      const int* __restrict__ sorted_gid,  // [max_dup]
                      const int* __restrict__ tile_starts,  // [T]
                      const int* __restrict__ tile_counts,  // [T]
                      const float* __restrict__ final_t,    // [H, W]
                      const int* __restrict__ n_contrib,    // [H, W]
                      const float* __restrict__ g_img4,     // [4, H, W]
                      const float* __restrict__ g_final_t,  // [H, W]
                      int gw, int tile_w, int tile_h, int patch_w, int width,
                      int height, float alpha_min,
                      float* __restrict__ egrads) {         // [max_dup, 12]
  extern __shared__ float4 smem[];
  __shared__ int s_wnc[32];            // per-warp largest n_contrib
  const int nwarps = blockDim.x >> 5;
  float4* s_feat = smem;               // [kStages][kBatch][3] feature rows
  // [2][kBatch][nwarps][kSums] per-warp partial sums, by batch parity
  float* s_part = reinterpret_cast<float*>(smem + kStages * kBatch * 3);

  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];

  // this warp's patch of patch_w x 32*P/patch_w pixels: the lanes form a
  // lw x 32/lw grid (lw = patch_w / P), and lane (lx, ly) takes the P
  // pixels (lx + p*lw, ly) of patch row ly, which share dy
  const int lw = patch_w / P;
  const int patches_x = tile_w / patch_w;
  const int x0 = (tile % gw) * tile_w + (warp % patches_x) * patch_w +
                 lane % lw;
  const int py = (tile / gw) * tile_h + (warp / patches_x) * (32 / lw) +
                 lane / lw;
  const float pyf = static_cast<float>(py);

  // pixels outside the image have n_contrib 0: they apply nothing but join
  // every barrier and every warp reduction
  float pxf[P], T[P], S[P], g0[P], g1[P], g2[P], g3[P];
  int nc[P];
  int wnc = 0;
  const size_t hw = static_cast<size_t>(width) * height;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int px = x0 + p * lw;
    pxf[p] = static_cast<float>(px);
    T[p] = S[p] = g0[p] = g1[p] = g2[p] = g3[p] = 0.0f;
    nc[p] = 0;
    if (px < width && py < height) {
      const size_t pix = static_cast<size_t>(py) * width + px;
      T[p] = final_t[pix];
      nc[p] = n_contrib[pix];
      g0[p] = g_img4[pix];
      g1[p] = g_img4[hw + pix];
      g2[p] = g_img4[2 * hw + pix];
      g3[p] = g_img4[3 * hw + pix];
      // S starts at the final-T cotangent term g_T * final_t, so that
      // S / (1 - alpha) is the whole second term of dL/dalpha
      S[p] = g_final_t[pix] * T[p];
    }
    wnc = max(wnc, nc[p]);
  }
  wnc = min(__reduce_max_sync(kFull, wnc), count);
  if (lane == 0) s_wnc[warp] = wnc;
  __syncthreads();
  int max_nc = 0;
  for (int w = 0; w < nwarps; ++w) max_nc = max(max_nc, s_wnc[w]);
  const int nbat = (max_nc + kBatch - 1) / kBatch;

  // batch i holds entries [base, end), end = max_nc - i*kBatch
  auto batch_base = [&](int i) { return max(max_nc - (i + 1) * kBatch, 0); };
  auto batch_size = [&](int i) { return max_nc - i * kBatch - batch_base(i); };
  // warp 0: lane t loads entries t, t + 32, ... of a batch; gid_of gives
  // their sorted_gid, issue copies their rows
  auto gid_of = [&](int i, int (&g)[kBatch / 32]) {
#pragma unroll
    for (int m = 0; m < kBatch / 32; ++m) {
      const int e = m * 32 + lane;
      g[m] = (i < nbat && e < batch_size(i))
                 ? sorted_gid[start + batch_base(i) + e] : 0;
    }
  };
  auto issue = [&](int i, const int (&g)[kBatch / 32]) {
#pragma unroll
    for (int m = 0; m < kBatch / 32; ++m) {
      const int e = m * 32 + lane;
      if (i < nbat && e < batch_size(i)) {
        const float4* row = feats + 3 * static_cast<size_t>(g[m]);
        float4* dst = s_feat + ((i % kStages) * kBatch + e) * 3;
        cp_async16(dst, row);
        cp_async16(dst + 1, row + 1);
        cp_async16(dst + 2, row + 2);
      }
    }
    cp_async_commit();                  // one group per batch, maybe empty
  };

  // cross-warp sums of batch i in warp order and its egrads rows: lanes
  // 10e..10e+9 take entry j0 + e, lane c its sum c
  auto write_out = [&](int i) {
    const int base = batch_base(i);
    const int nb = batch_size(i);
    const float* part = s_part + (i & 1) * kBatch * nwarps * kSums;
    const float4* f = s_feat + (i % kStages) * kBatch * 3;
    const int e = lane / kSums;
    const int c = lane - e * kSums;
    for (int j0 = warp * 3; j0 < nb; j0 += nwarps * 3) {
      const int j = j0 + e;
      const bool mine = e < 3 && j < nb;
      float s = 0.0f;
      if (mine) {
        const float* col = part + j * nwarps * kSums + c;
        for (int w = 0; w < nwarps; ++w)
          if (base + j < s_wnc[w]) s += col[w * kSums];
      }
      const float pair = __shfl_xor_sync(kFull, s, 1);   // su <-> sv
      if (mine) {
        if (c < 2) {
          const float4 a = f[3 * j];                      // x, y, s0, s1
          const float s_own = c == 0 ? a.z : f[3 * j + 1].x;
          s = 2.0f * s_own * s + a.w * pair;              // d gx, d gy
        } else if (c == 5) {
          s = s / fmaxf(f[3 * j + 1].y, 1e-30f);          // d opacity
        }
        egrads[static_cast<size_t>(start + base + j) * kCols + c] = s;
      }
    }
  };

  const float log_amin = logf(alpha_min) - 0.05f;
  // this warp's walk of batch i, back to front; partials of entry j go to
  // [i & 1][j][warp][:] wherever this warp walks it
  auto walk = [&](int i) {
    const int base = batch_base(i);
    if (base >= wnc) return;                   // dead warp for this batch
    float* part = s_part + (i & 1) * kBatch * nwarps * kSums;
    const float4* f = s_feat + (i % kStages) * kBatch * 3;
    for (int j = min(batch_size(i), wnc - base) - 1; j >= 0; --j) {
      const int k = base + j;
      const float4 a = f[3 * j];               // x, y, s0, s1
      const float4 b = f[3 * j + 1];           // s2, opacity, r, g
      const float4 cf = f[3 * j + 2];          // b, invdepth, t, 1/kids
      // below this power op * exp(power) < 0.95 alpha_min, so the flat
      // path skips the exp of pairs that were surely not applied
      const float reject = LOD ? 0.0f : log_amin - __logf(b.y);
      // the parts of power that depend on dy only (B1's operation order)
      const float dy = __fsub_rn(a.y, pyf);
      const float s1dy = __fmul_rn(a.w, dy);
      const float s2dy2 = __fmul_rn(__fmul_rn(b.x, dy), dy);
      // straight-line first: power at the P pixels and which of them may
      // have applied the entry; a warp where none may skips the rest
      float dxs[P], powers[P];
      bool live[P];
      bool any_live = false;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        dxs[p] = __fsub_rn(a.x, pxf[p]);
        powers[p] = __fadd_rn(
            __fmul_rn(dxs[p], __fadd_rn(__fmul_rn(a.z, dxs[p]), s1dy)),
            s2dy2);
        live[p] = k < nc[p] && !(powers[p] > 0.0f) &&
                  (LOD || !(powers[p] < reject));
        any_live |= live[p];
      }
      float* dst = part + (j * nwarps + warp) * kSums;
      if (!__any_sync(kFull, any_live)) {
        if (lane < kSums) dst[lane] = 0.0f;
        continue;
      }
      float acc[kSums];
#pragma unroll
      for (int s = 0; s < kSums; ++s) acc[s] = 0.0f;
      bool applied = false;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (!live[p]) continue;
        const float dx = dxs[p];
        const float opG = __fmul_rn(b.y, expf(powers[p]));
        float alpha = fminf(0.99f, opG);
        float dalpha_dmy = 1.0f;
        if (LOD) {
          const float one_m_my = fmaxf(__fsub_rn(1.0f, alpha), 1e-12f);
          const float pw = expf(__fmul_rn(cf.w, logf(one_m_my)));
          alpha = __fadd_rn(__fmul_rn(cf.z, alpha),
                            __fmul_rn(__fsub_rn(1.0f, cf.z),
                                      __fsub_rn(1.0f, pw)));
          dalpha_dmy = cf.z + (1.0f - cf.z) * cf.w * pw / one_m_my;
        }
        if (alpha < alpha_min) continue;
        applied = true;
        const float one_m = __fsub_rn(1.0f, alpha);
        const float t_before = __fdiv_rn(T[p], one_m);
        const float contrib = alpha * t_before;
        const float cdotg = b.z * g0[p] + b.w * g1[p] + cf.x * g2[p] +
                            cf.y * g3[p];
        // the T rebuild above is IEEE; this term tolerates a 2-ulp divide
        const float dal = cdotg * t_before - __fdividef(S[p], one_m);
        S[p] += contrib * cdotg;
        T[p] = t_before;
        const float dpower = opG < 0.99f ? opG * (dal * dalpha_dmy) : 0.0f;
        const float u = dx * dpower;
        const float v = dy * dpower;
        acc[0] += u;
        acc[1] += v;
        acc[2] += dx * u;
        acc[3] += dy * u;
        acc[4] += dy * v;
        acc[5] += dpower;
        acc[6] += contrib * g0[p];
        acc[7] += contrib * g1[p];
        acc[8] += contrib * g2[p];
        acc[9] += contrib * g3[p];
      }
      if (!__any_sync(kFull, applied)) {
        if (lane < kSums) dst[lane] = 0.0f;
        continue;
      }
      int c;
      const float z = reduce_scatter10(acc, lane, &c);
      if (c >= 0) dst[c] = z;
    }
  };

  int gid_next[kBatch / 32] = {};
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kStages - 2; ++i) {
      gid_of(i, gid_next);
      issue(i, gid_next);
    }
    gid_of(kStages - 2, gid_next);
  }
  for (int i = 0; i < nbat; ++i) {
    if (warp == 0) cp_async_wait<kStages - 3>();     // batch i has landed
    __syncthreads();
    if (warp == 0) {
      issue(i + kStages - 2, gid_next);            // into batch i-2's slot
      gid_of(i + kStages - 1, gid_next);
    }
    if (i > 0) write_out(i - 1);
    walk(i);
  }
  __syncthreads();
  if (nbat > 0) write_out(nbat - 1);
}

// Pixels per thread and the warp patch width for a tile shape (the tile's
// pixel count a multiple of 32, at most 1024): P is the largest of 4, 2, 1
// (at most kMaxP) for which the tile splits into warp patches of pw x
// 32*P/pw pixels with pw | tile_w, 32*P/pw | tile_h and P | pw (a lane's P
// pixels lie in one patch row, pw/P lanes across); the patch is the
// squarest such (wider on a tie). P = 1 with pw = gcd(tile_w, 32) always
// qualifies. P is the largest the pixel count allows except on tiles
// narrower than 16 whose width is not a multiple of 4 (6x64 runs P = 2,
// 3x128 P = 1).
void launch_shape(int tile_w, int tile_h, int* p, int* patch_w) {
  const int npix = tile_w * tile_h;
  for (int cand = kMaxP; cand >= 1; cand /= 2) {
    const int n = 32 * cand;
    if (npix % n) continue;
    int best = 0;
    for (int pw = cand; pw <= n && pw <= tile_w; pw += cand) {
      if (tile_w % pw || 32 % (pw / cand) || tile_h % (n / pw)) continue;
      if (!best || pw + n / pw <= best + n / best) best = pw;
    }
    if (best) {
      *p = cand;
      *patch_w = best;
      return;
    }
  }
}

template <bool LOD, int P>
cudaError_t launch(const void* feats, const void* sorted_gid,
                   const void* tile_starts, const void* tile_counts,
                   const void* final_t, const void* n_contrib,
                   const void* g_img4, const void* g_final_t, int num_tiles,
                   int gw, int tile_w, int tile_h, int patch_w, int width,
                   int height, float alpha_min, void* egrads,
                   cudaStream_t stream) {
  const int nthr = tile_w * tile_h / P;
  const size_t smem =
      kStages * kBatch * 3 * sizeof(float4) +
      static_cast<size_t>(2 * kBatch) * (nthr / 32) * kSums * sizeof(float);
  auto kernel = blend_backward_kernel<LOD, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<num_tiles, nthr, smem, stream>>>(
      static_cast<const float4*>(feats), static_cast<const int*>(sorted_gid),
      static_cast<const int*>(tile_starts),
      static_cast<const int*>(tile_counts),
      static_cast<const float*>(final_t), static_cast<const int*>(n_contrib),
      static_cast<const float*>(g_img4), static_cast<const float*>(g_final_t),
      gw, tile_w, tile_h, patch_w, width, height, alpha_min,
      static_cast<float*>(egrads));
  return cudaGetLastError();
}

template <bool LOD>
cudaError_t launch_p(int p, const void* feats, const void* sorted_gid,
                     const void* tile_starts, const void* tile_counts,
                     const void* final_t, const void* n_contrib,
                     const void* g_img4, const void* g_final_t,
                     int num_tiles, int gw, int tile_w, int tile_h,
                     int patch_w, int width, int height, float alpha_min,
                     void* egrads, cudaStream_t stream) {
  decltype(&launch<LOD, 1>) fn =
      p == 4 ? &launch<LOD, 4> : p == 2 ? &launch<LOD, 2> : &launch<LOD, 1>;
  return fn(feats, sorted_gid, tile_starts, tile_counts, final_t, n_contrib,
            g_img4, g_final_t, num_tiles, gw, tile_w, tile_h, patch_w, width,
            height, alpha_min, egrads, stream);
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; egrads must arrive zeroed (entries past a
// tile's last applied one, and columns 10-11, are not written). Returns the
// launch's cudaError_t.
extern "C" int blend_backward_launch(
    const void* feats, const void* sorted_gid, const void* tile_starts,
    const void* tile_counts, const void* final_t, const void* n_contrib,
    const void* g_img4, const void* g_final_t, int num_tiles, int gw,
    int tile_w, int tile_h, int width, int height, float alpha_min,
    int use_lod, void* egrads, void* stream) {
  const int npix = tile_w * tile_h;
  if (tile_w <= 0 || tile_h <= 0 || npix > 1024 || npix % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  int p, patch_w;
  launch_shape(tile_w, tile_h, &p, &patch_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      use_lod ? launch_p<true>(p, feats, sorted_gid, tile_starts, tile_counts,
                               final_t, n_contrib, g_img4, g_final_t,
                               num_tiles, gw, tile_w, tile_h, patch_w, width,
                               height, alpha_min, egrads, s)
              : launch_p<false>(p, feats, sorted_gid, tile_starts,
                                tile_counts, final_t, n_contrib, g_img4,
                                g_final_t, num_tiles, gw, tile_w, tile_h,
                                patch_w, width, height, alpha_min, egrads, s);
  return static_cast<int>(err);
}

extern "C" const char* blend_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
