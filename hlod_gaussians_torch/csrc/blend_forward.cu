// Kernel B1: per-tile front-to-back alpha blend (forward render).
//
// Replaces: hlod_gaussians_tpu/ops/rasterize_pallas.py::blend_forward
// (_forward_kernel/_forward_tile and _forward_kernel_il, shared math
// _chunk_alpha). Plain version: hlod_gaussians_torch/ops/rasterize_xla.py
// ::blend_forward_plain. Wrapper: hlod_gaussians_torch/ops/rasterize_cuda.py.
//
// What it computes, per tile, over the tile's depth-sorted entries:
//   power = s0*dx^2 + s1*dx*dy + s2*dy^2   (pre-scaled conic, dx = gx - px)
//   alpha = min(0.99, op * exp(power))
//   LOD:  alpha = t*alpha + (1-t)*(1 - exp(ik * log(max(1-alpha, 1e-12))))
//   skip the entry if power > 0 or alpha < alpha_min;
//   test_t = T*(1-alpha); if test_t < t_eps the pixel is done (sticky, the
//   entry is dropped); else accumulate rgb and inverse depth with weight
//   alpha*T, set T = test_t and n_contrib = k+1.
//
// Design: the TPU kernel evaluates a [128 entries x pixels] chunk matrix in
// closed form (cumulative products on the VPU, color sums on the MXU). On
// Hopper the reference's own shape fits: one block per tile, one thread per
// pixel (tile_w*tile_h <= 1024), and each thread runs the serial loop.
// Entries go through shared memory in batches of blockDim: each thread
// loads one entry's gid and its 48-byte feature row (three float4 loads),
// then every thread walks the batch. The block leaves as soon as every
// pixel is done (__syncthreads_count vote at each batch boundary); pixels
// outside the image count as done but join every barrier.
//
// Bound on this card: operations. Per evaluated (entry, pixel) pair the loop
// does about 25 f32 operations against 48 bytes read once per entry and 24
// bytes written per pixel, so at the 1080p bench frame the f32 rate, not
// memory, is the floor. The decision arithmetic (power, LOD alpha, T) uses
// _rn intrinsics so nvcc does not contract it into FMAs: the skip and
// early-stop decisions then round exactly as the plain PyTorch version's
// separate ops do, and only expf/logf's last bits differ between the two.
// Accumulations may use FMAs. Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

template <bool LOD, bool SEEN>
__global__ void __launch_bounds__(1024)
blend_forward_kernel(const float4* __restrict__ feats,    // [N, 3] float4
                     const int* __restrict__ sorted_gid,  // [max_dup]
                     const int* __restrict__ tile_starts,  // [T]
                     const int* __restrict__ tile_counts,  // [T]
                     int gw, int tile_w, int tile_h, int width, int height,
                     float t_eps, float alpha_min,
                     float* __restrict__ img4,             // [4, H, W]
                     float* __restrict__ final_t,          // [H, W]
                     int* __restrict__ n_contrib,          // [H, W]
                     unsigned char* __restrict__ seen) {   // [N] or null
  extern __shared__ float4 smem[];
  const int nthr = blockDim.x;
  float4* s_f0 = smem;                 // x, y, s0, s1
  float4* s_f1 = smem + nthr;          // s2, opacity, r, g
  float4* s_f2 = smem + 2 * nthr;      // b, invdepth, t, 1/kids
  int* s_gid = reinterpret_cast<int*>(smem + 3 * nthr);

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int px = (tile % gw) * tile_w + tid % tile_w;
  const int py = (tile / gw) * tile_h + tid / tile_w;
  const bool inside = px < width && py < height;
  const float pxf = static_cast<float>(px);
  const float pyf = static_cast<float>(py);
  const int start = tile_starts[tile];
  const int count = tile_counts[tile];

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int last = 0;
  bool done = !inside;

  for (int base = 0; base < count; base += nthr) {
    // the barrier also guarantees the previous batch was fully consumed
    if (__syncthreads_count(!done) == 0) break;
    const int k = base + tid;
    if (k < count) {
      const int g = sorted_gid[start + k];
      const float4* row = feats + 3 * static_cast<size_t>(g);
      s_f0[tid] = row[0];
      s_f1[tid] = row[1];
      s_f2[tid] = row[2];
      if (SEEN) s_gid[tid] = g;
    }
    __syncthreads();
    const int nb = min(nthr, count - base);
    for (int j = 0; !done && j < nb; ++j) {
      const float4 a = s_f0[j];
      const float4 b = s_f1[j];
      const float dx = __fsub_rn(a.x, pxf);
      const float dy = __fsub_rn(a.y, pyf);
      const float power = __fadd_rn(
          __fmul_rn(dx, __fadd_rn(__fmul_rn(a.z, dx), __fmul_rn(a.w, dy))),
          __fmul_rn(__fmul_rn(b.x, dy), dy));
      if (power > 0.0f) continue;
      float alpha = fminf(0.99f, __fmul_rn(b.y, expf(power)));
      const float4 c = s_f2[j];
      if (LOD) {
        const float pw = expf(
            __fmul_rn(c.w, logf(fmaxf(__fsub_rn(1.0f, alpha), 1e-12f))));
        alpha = __fadd_rn(__fmul_rn(c.z, alpha),
                          __fmul_rn(__fsub_rn(1.0f, c.z),
                                    __fsub_rn(1.0f, pw)));
      }
      if (alpha < alpha_min) continue;
      const float test_t = __fmul_rn(T, __fsub_rn(1.0f, alpha));
      if (test_t < t_eps) {
        done = true;
        break;
      }
      const float w = __fmul_rn(alpha, T);
      acc_r += w * b.z;
      acc_g += w * b.w;
      acc_b += w * c.x;
      acc_d += w * c.y;
      T = test_t;
      last = base + j + 1;
      if (SEEN) seen[s_gid[j]] = 1;  // racy but idempotent
    }
  }

  if (inside) {
    const size_t hw = static_cast<size_t>(width) * height;
    const size_t pix = static_cast<size_t>(py) * width + px;
    img4[pix] = acc_r;
    img4[hw + pix] = acc_g;
    img4[2 * hw + pix] = acc_b;
    img4[3 * hw + pix] = acc_d;
    final_t[pix] = T;
    n_contrib[pix] = last;
  }
}

template <bool LOD, bool SEEN>
cudaError_t launch(const void* feats, const void* sorted_gid,
                   const void* tile_starts, const void* tile_counts,
                   int num_tiles, int gw, int tile_w, int tile_h, int width,
                   int height, float t_eps, float alpha_min, void* img4,
                   void* final_t, void* n_contrib, void* seen,
                   cudaStream_t stream) {
  const int nthr = tile_w * tile_h;
  const size_t smem = static_cast<size_t>(nthr) * (3 * sizeof(float4) + sizeof(int));
  auto kernel = blend_forward_kernel<LOD, SEEN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<num_tiles, nthr, smem, stream>>>(
      static_cast<const float4*>(feats), static_cast<const int*>(sorted_gid),
      static_cast<const int*>(tile_starts),
      static_cast<const int*>(tile_counts), gw, tile_w, tile_h, width,
      height, t_eps, alpha_min, static_cast<float*>(img4),
      static_cast<float*>(final_t), static_cast<int*>(n_contrib),
      static_cast<unsigned char*>(seen));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the launch's cudaError_t.
extern "C" int blend_forward_launch(
    const void* feats, const void* sorted_gid, const void* tile_starts,
    const void* tile_counts, int num_tiles, int gw, int tile_w, int tile_h,
    int width, int height, float t_eps, float alpha_min, int use_lod,
    void* img4, void* final_t, void* n_contrib, void* seen, void* stream) {
  const int nthr = tile_w * tile_h;
  if (nthr <= 0 || nthr > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_lod) {
    err = seen ? launch<true, true>(feats, sorted_gid, tile_starts, tile_counts, num_tiles, gw,
                                    tile_w, tile_h, width, height, t_eps, alpha_min, img4,
                                    final_t, n_contrib, seen, s)
               : launch<true, false>(feats, sorted_gid, tile_starts, tile_counts, num_tiles, gw,
                                     tile_w, tile_h, width, height, t_eps, alpha_min, img4,
                                     final_t, n_contrib, seen, s);
  } else {
    err = seen ? launch<false, true>(feats, sorted_gid, tile_starts, tile_counts, num_tiles, gw,
                                     tile_w, tile_h, width, height, t_eps, alpha_min, img4,
                                     final_t, n_contrib, seen, s)
               : launch<false, false>(feats, sorted_gid, tile_starts, tile_counts, num_tiles, gw,
                                      tile_w, tile_h, width, height, t_eps, alpha_min, img4,
                                      final_t, n_contrib, seen, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* blend_forward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
