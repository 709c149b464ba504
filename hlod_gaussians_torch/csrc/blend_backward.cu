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
//   egrads [max_dup, 12]: dgx, dgy, d(s0, s1, s2), dop, drgb, dinvdepth,
//   0, 0 (t and 1/kids carry no gradient).
//
// Design: the TPU kernel evaluates [128 entries x pixels] chunks in closed
// form (prefix products, triangular suffix sums). Here the reference's own
// shape serves, as in B1: one block per tile, one thread per pixel
// (tile_w*tile_h a multiple of 32, at most 1024), each thread carrying its
// pixel's T and S serially. Entries go through shared memory in batches of
// kBatch. Every entry belongs to exactly one tile, so its gradient is a
// reduction over the block's pixels: ten pixel sums (u, v, dpower, dx*u,
// dy*u, dy*v and the four colour sums) are summed across each warp with an
// xor butterfly (skipped when no lane of the warp applied the entry), the
// per-warp partials wait in shared memory, and after the batch one thread
// per (entry, sum) adds the warps in index order. The row is then written
// once. No atomics touch global memory and every sum runs in a fixed
// order, so two launches on the same inputs give the same bits.
//
// Shared memory: kBatch rows of features (48 B each) plus the partials,
// nwarps * kBatch * 10 floats = 40 KB at 32x32 tiles with kBatch = 32.
//
// Bound on this card: operations. Per needed (entry, pixel) pair about 15
// f32 operations decide whether it was applied and about 27 more follow for
// an applied pair, against 48 bytes of features per entry and 28 bytes of
// per-pixel inputs; the warp reductions add shuffles that the bound does
// not count. The decision arithmetic (power, LOD alpha) uses the _rn
// intrinsics exactly as blend_forward.cu does, so both kernels and the
// plain version agree on the applied set; the T rebuild uses IEEE division.
// Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 32;   // entries per shared-memory batch
constexpr int kSums = 10;    // pixel sums reduced per entry
constexpr unsigned kFull = 0xffffffffu;

template <bool LOD>
__global__ void __launch_bounds__(1024)
blend_backward_kernel(const float4* __restrict__ feats,    // [N, 3] float4
                      const int* __restrict__ sorted_gid,  // [max_dup]
                      const int* __restrict__ tile_starts,  // [T]
                      const int* __restrict__ tile_counts,  // [T]
                      const float* __restrict__ final_t,    // [H, W]
                      const int* __restrict__ n_contrib,    // [H, W]
                      const float* __restrict__ g_img4,     // [4, H, W]
                      const float* __restrict__ g_final_t,  // [H, W]
                      int gw, int tile_w, int tile_h, int width, int height,
                      float alpha_min,
                      float4* __restrict__ egrads) {        // [max_dup, 3]
  extern __shared__ float4 smem[];
  __shared__ int s_max_nc;
  const int nthr = blockDim.x;
  const int nwarps = nthr >> 5;
  float4* s_f0 = smem;                 // x, y, s0, s1
  float4* s_f1 = smem + kBatch;        // s2, opacity, r, g
  float4* s_f2 = smem + 2 * kBatch;    // b, invdepth, t, 1/kids
  // per-warp partial sums [nwarps][kBatch][kSums]
  float* s_part = reinterpret_cast<float*>(smem + 3 * kBatch);

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int px = (tile % gw) * tile_w + tid % tile_w;
  const int py = (tile / gw) * tile_h + tid / tile_w;
  const bool inside = px < width && py < height;
  const float pxf = static_cast<float>(px);
  const float pyf = static_cast<float>(py);
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];

  // pixels outside the image have n_contrib 0: they apply nothing but join
  // every barrier and every warp reduction
  float T = 0.0f, dTf = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, g3 = 0.0f;
  int nc = 0;
  if (inside) {
    const size_t hw = static_cast<size_t>(width) * height;
    const size_t pix = static_cast<size_t>(py) * width + px;
    T = final_t[pix];
    nc = n_contrib[pix];
    g0 = g_img4[pix];
    g1 = g_img4[hw + pix];
    g2 = g_img4[2 * hw + pix];
    g3 = g_img4[3 * hw + pix];
    dTf = g_final_t[pix] * T;
  }
  if (tid == 0) s_max_nc = 0;
  __syncthreads();
  if (nc > 0) atomicMax(&s_max_nc, nc);
  __syncthreads();
  const int max_nc = min(s_max_nc, count);

  float S = 0.0f;
  for (int end = max_nc; end > 0; end -= kBatch) {
    const int base = max(end - kBatch, 0);
    const int nb = end - base;
    // the previous batch's features and partials are fully consumed
    __syncthreads();
    if (tid < nb) {
      const int g = sorted_gid[start + base + tid];
      const float4* row = feats + 3 * static_cast<size_t>(g);
      s_f0[tid] = row[0];
      s_f1[tid] = row[1];
      s_f2[tid] = row[2];
    }
    __syncthreads();

    for (int j = nb - 1; j >= 0; --j) {
      float sums[kSums];
#pragma unroll
      for (int c = 0; c < kSums; ++c) sums[c] = 0.0f;
      bool applied = false;
      if (base + j < nc) {
        const float4 a = s_f0[j];
        const float4 b = s_f1[j];
        const float dx = __fsub_rn(a.x, pxf);
        const float dy = __fsub_rn(a.y, pyf);
        const float power = __fadd_rn(
            __fmul_rn(dx, __fadd_rn(__fmul_rn(a.z, dx), __fmul_rn(a.w, dy))),
            __fmul_rn(__fmul_rn(b.x, dy), dy));
        if (!(power > 0.0f)) {
          const float4 c = s_f2[j];
          const float opG = __fmul_rn(b.y, expf(power));
          float alpha = fminf(0.99f, opG);
          float dalpha_dmy = 1.0f;
          if (LOD) {
            const float one_m_my = fmaxf(__fsub_rn(1.0f, alpha), 1e-12f);
            const float pw = expf(__fmul_rn(c.w, logf(one_m_my)));
            alpha = __fadd_rn(__fmul_rn(c.z, alpha),
                              __fmul_rn(__fsub_rn(1.0f, c.z),
                                        __fsub_rn(1.0f, pw)));
            dalpha_dmy = c.z + (1.0f - c.z) * c.w * pw / one_m_my;
          }
          if (!(alpha < alpha_min)) {
            applied = true;
            const float one_m = __fsub_rn(1.0f, alpha);
            const float t_before = __fdiv_rn(T, one_m);
            const float contrib = alpha * t_before;
            const float cdotg = b.z * g0 + b.w * g1 + c.x * g2 + c.y * g3;
            const float dal = cdotg * t_before - (S + dTf) / one_m;
            S += contrib * cdotg;
            T = t_before;
            const float dpower = opG < 0.99f ? opG * (dal * dalpha_dmy)
                                             : 0.0f;
            const float u = dx * dpower;
            const float v = dy * dpower;
            sums[0] = u;
            sums[1] = v;
            sums[2] = dpower;
            sums[3] = dx * u;
            sums[4] = dy * u;
            sums[5] = dy * v;
            sums[6] = contrib * g0;
            sums[7] = contrib * g1;
            sums[8] = contrib * g2;
            sums[9] = contrib * g3;
          }
        }
      }
      float* part = s_part + (warp * kBatch + j) * kSums;
      if (__any_sync(kFull, applied)) {
#pragma unroll
        for (int c = 0; c < kSums; ++c) {
          float x = sums[c];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
          if (lane == 0) part[c] = x;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kSums; ++c) part[c] = 0.0f;
      }
    }
    __syncthreads();

    // cross-warp sums in warp order, into warp 0's slots: thread (j, c)
    // alone reads and writes column (j, c)
    for (int idx = tid; idx < nb * kSums; idx += nthr) {
      const int j = idx / kSums;
      const int c = idx - j * kSums;
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += s_part[(w * kBatch + j) * kSums + c];
      s_part[j * kSums + c] = s;
    }
    __syncthreads();

    if (tid < nb) {
      const float* r = s_part + tid * kSums;
      const float4 a = s_f0[tid];
      const float4 b = s_f1[tid];
      const float su = r[0], sv = r[1];
      float4* out = egrads + 3 * static_cast<size_t>(start + base + tid);
      out[0] = make_float4(2.0f * a.z * su + a.w * sv,    // d gx
                           2.0f * b.x * sv + a.w * su,    // d gy
                           r[3], r[4]);                   // d s0, d s1
      out[1] = make_float4(r[5], r[2] / fmaxf(b.y, 1e-30f),  // d s2, d op
                           r[6], r[7]);                   // d r, d g
      out[2] = make_float4(r[8], r[9], 0.0f, 0.0f);       // d b, d invd
    }
  }
}

template <bool LOD>
cudaError_t launch(const void* feats, const void* sorted_gid,
                   const void* tile_starts, const void* tile_counts,
                   const void* final_t, const void* n_contrib,
                   const void* g_img4, const void* g_final_t, int num_tiles,
                   int gw, int tile_w, int tile_h, int width, int height,
                   float alpha_min, void* egrads, cudaStream_t stream) {
  const int nthr = tile_w * tile_h;
  const size_t smem = 3 * kBatch * sizeof(float4) +
                      static_cast<size_t>(nthr / 32) * kBatch * kSums * sizeof(float);
  auto kernel = blend_backward_kernel<LOD>;
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
      gw, tile_w, tile_h, width, height, alpha_min,
      static_cast<float4*>(egrads));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; egrads must arrive zeroed (entries past a
// tile's last applied one are not written). Returns the launch's cudaError_t.
extern "C" int blend_backward_launch(
    const void* feats, const void* sorted_gid, const void* tile_starts,
    const void* tile_counts, const void* final_t, const void* n_contrib,
    const void* g_img4, const void* g_final_t, int num_tiles, int gw,
    int tile_w, int tile_h, int width, int height, float alpha_min,
    int use_lod, void* egrads, void* stream) {
  const int nthr = tile_w * tile_h;
  if (nthr <= 0 || nthr > 1024 || nthr % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      use_lod ? launch<true>(feats, sorted_gid, tile_starts, tile_counts,
                             final_t, n_contrib, g_img4, g_final_t, num_tiles,
                             gw, tile_w, tile_h, width, height, alpha_min,
                             egrads, s)
              : launch<false>(feats, sorted_gid, tile_starts, tile_counts,
                              final_t, n_contrib, g_img4, g_final_t,
                              num_tiles, gw, tile_w, tile_h, width, height,
                              alpha_min, egrads, s);
  return static_cast<int>(err);
}

extern "C" const char* blend_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
