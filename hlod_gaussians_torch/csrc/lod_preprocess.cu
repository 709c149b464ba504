// Kernel lod_preprocess: the masked LOD path's per-row preparation of the
// renderer's inputs, from the InterpTable to kernel B1's feature rows and
// the binning's inputs, in one pass.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it (hierarchy/cut.py::interpolate_all_masked, render.py's skybox
// prepend and quaternion normalisation, ops/gaussian_math.py's cov3d and
// projection, ops/sh.py::sh_color, rasterize_xla.py::blend_features). As
// separate PyTorch kernels that chain writes the lerped [C, D] rows and SH
// temporaries of [C, 16, 3] to device memory and reads them back column by
// column. Plain version: hlod_gaussians_torch/ops/lod_preprocess.py
// ::lod_preprocess_plain. Wrapper: ::lod_preprocess.
//
// What it computes, for output row r of M = n_sky + C: rows r < n_sky are
// the skybox, table row r's own half at t = 1, drawn where alive[r]; row
// n_sky + j is node j, drawn where mask[j], lerped t * child + (1 - t) *
// parent with t = ts[j]. A drawn row's quaternion is normalised, its 3D
// covariance built, projected (EWA, dilation, near plane, det, big_limit,
// the antialiasing opacity, radius, the tight extents of alpha >=
// alpha_min) and its colour taken from SH of degree DEG. Out go the
// [M, 12] feature rows in blend_features' layout (x, y, the pre-scaled
// conic, opacity, rgb, inverse depth, t, 1/kids) and depth, radius, valid,
// ext and reff2. A row that is culled is sanitised as project_gaussians
// sanitises it (xy 0, conic (1, 0, 1), depth 1, opacity 0, radius 0, ext
// and reff2 0); a row that is not drawn is never read from the table and
// takes colour 0.
//
// Bound on this card: memory. A drawn row reads its table row once, 2 x
// (11 + 3 x 16) float32 = 472 bytes at SH 3; every row reads mask, ts and
// kids and writes 48 bytes of feature row and 21 of binning inputs. At the
// tau-0 cell's 8,388,607 rows, 4.18 M drawn, that is about 2.6 GB, 0.8 ms
// at 3.35 TB/s. About 600 f32 operations a drawn row (the lerp, 59 x 3;
// cov3d, the projection, SH 3: chip_smoke.py's OPS_LODPRE) are 2.5 GFLOP,
// 0.04 ms at 67 TFLOP/s.
//
// Design:
// - A warp takes 32 consecutive output rows. One ballot names the drawn
//   ones; the warp copies their table rows into shared memory with 8-byte
//   cp.async, lane k taking float2 k, k + 32, ... of each row, so every
//   copy instruction of the warp reads 256 contiguous bytes (a row is 472
//   bytes, 8 mod 16, so 16-byte copies would not align). The copies need
//   no registers and all of the warp's are in flight at once. Rows that
//   are not drawn never touch the table.
// - Then each lane computes its own row from shared memory: the lerp is
//   taken as each value is read and folded straight into the covariance,
//   the projection and the SH sum, so nothing intermediate reaches device
//   memory. The feature row goes out as three 16-byte stores.
// - Numerics: the arithmetic follows the plain version's column order, and
//   the source builds with -fmad=false, so no product is contracted into an
//   FMA: the discrete decisions (the near plane, det > 0, the radius ceil,
//   the extents) see the plain version's floats on all but boundary rows.
//   Division and sqrt are IEEE (no --use_fast_math); logf (the extents) is
//   within an ulp of the host's, and the SH sum runs in coefficient order
//   where PyTorch's reduction may pair them otherwise: both round, neither
//   decides.
//
// Budget per block: two warps, static shared memory 2 x 32 x 472 bytes
// (30,208) of staged rows and the camera; about seven blocks an SM by
// shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 2;          // warps a block
constexpr int kMaxRowF2 = 59;      // float2 of a table row at SH degree 3
constexpr unsigned kFull = 0xffffffffu;

// ops/sh.py's constants
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC20 = 1.0925484305920792f, kC21 = -1.0925484305920792f,
                kC22 = 0.31539156525252005f, kC23 = -1.0925484305920792f,
                kC24 = 0.5462742152960396f;
constexpr float kC30 = -0.5900435899266435f, kC31 = 2.890611442640554f,
                kC32 = -0.4570457994644658f, kC33 = 0.3731763325901154f,
                kC34 = -0.4570457994644658f, kC35 = 1.445305721320277f,
                kC36 = -0.5900435899266435f;

struct Params {
  const float2* table;          // [C, D] float2: child half, parent half
  const unsigned char* mask;    // [C]
  const float* ts;              // [C]
  const int* kids;              // [C]
  const unsigned char* alive;   // [C]; the first n_sky are read
  const float* world_view;      // [4, 4], row vectors: p @ V[:3] + V[3]
  const float* full_proj;       // [4, 4]
  const float* campos;          // [3]
  const float* tan_x_ptr;       // 0-d on the device, or null: tan_x
  const float* tan_y_ptr;
  float tan_x, tan_y;
  int c, d, n_sky, width, height;
  float dilation, near_z, big_limit, alpha_min;
  int antialiasing;
  float4* feats;                // [M, 3] float4
  float* depth;                 // [M]
  int* radius;                  // [M]
  unsigned char* valid;         // [M]
  float2* ext;                  // [M]
  float* reff2;                 // [M]
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int DEG>
__global__ void __launch_bounds__(kWarps * 32)
lod_preprocess_kernel(const Params prm) {
  __shared__ float2 s_rows[kWarps * 32 * kMaxRowF2];
  __shared__ float s_cam[40];   // view 0:16, proj 16:32, campos 32:35, tan

  const int tid = threadIdx.x;
  if (tid < 16) {
    s_cam[tid] = prm.world_view[tid];
  } else if (tid < 32) {
    s_cam[tid] = prm.full_proj[tid - 16];
  } else if (tid < 35) {
    s_cam[tid] = prm.campos[tid - 32];
  } else if (tid == 35) {
    s_cam[35] = prm.tan_x_ptr ? *prm.tan_x_ptr : prm.tan_x;
  } else if (tid == 36) {
    s_cam[36] = prm.tan_y_ptr ? *prm.tan_y_ptr : prm.tan_y;
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long m = static_cast<long long>(prm.n_sky) + prm.c;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * 32;
  const long long r = base + lane;
  const bool in = r < m;
  const bool sky = r < prm.n_sky;
  const long long j = sky ? r : r - prm.n_sky;   // the table row
  bool drawn = false;
  float t = 1.0f;
  float ik = 1.0f;
  if (in) {
    if (sky) {
      drawn = prm.alive[j] != 0;
    } else {
      drawn = prm.mask[j] != 0;
      if (drawn) t = prm.ts[j];
      ik = 1.0f / static_cast<float>(max(prm.kids[j], 1));
    }
  }

  // stage the drawn rows: row l of the warp into slot l
  const int dw = prm.d;                          // float2 a table row
  float2* slots = s_rows + warp * 32 * kMaxRowF2;
  for (unsigned left = __ballot_sync(kFull, drawn); left;
       left &= left - 1) {
    const int l = __ffs(left) - 1;
    const long long rl = base + l;
    const long long jl = rl < prm.n_sky ? rl : rl - prm.n_sky;
    const float2* src = prm.table + static_cast<size_t>(jl) * dw;
    float2* dst = slots + l * dw;
    for (int k = lane; k < dw; k += 32) cp_async8(dst + k, src + k);
  }
  cp_async_wait_all();
  __syncwarp();

  float xo = 0.0f, yo = 0.0f, c0 = 1.0f, c1 = 0.0f, c2 = 1.0f;
  float opo = 0.0f, depo = 1.0f, exo = 0.0f, eyo = 0.0f, reffo = 0.0f;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  int rado = 0;
  bool valid = false;
  if (drawn) {
    const float* ch = reinterpret_cast<const float*>(slots + lane * dw);
    const float* pa = ch + dw;                   // parent half at float D
    const float omt = 1.0f - t;
    auto at = [&](int k) {
      return sky ? ch[k] : t * ch[k] + omt * pa[k];
    };
    const float* V = s_cam;
    const float* P = s_cam + 16;

    const float mx = at(0), my = at(1), mz = at(2);
    const float sx = at(3), sy = at(4), sz = at(5);
    float qw = at(6), qx = at(7), qy = at(8), qz = at(9);
    const float op = at(10);
    // the renderer's normalisation, then compute_cov3d's own
    const float qn =
        fmaxf(sqrtf(qw * qw + qx * qx + qy * qy + qz * qz), 1e-12f);
    qw = qw / qn;
    qx = qx / qn;
    qy = qy / qn;
    qz = qz / qn;
    const float inv =
        1.0f / sqrtf(fmaxf(qw * qw + qx * qx + qy * qy + qz * qz, 1e-24f));
    const float rr = qw * inv, x = qx * inv, y = qy * inv, z = qz * inv;
    const float r00 = 1.0f - 2.0f * (y * y + z * z);
    const float r01 = 2.0f * (x * y - rr * z);
    const float r02 = 2.0f * (x * z + rr * y);
    const float r10 = 2.0f * (x * y + rr * z);
    const float r11 = 1.0f - 2.0f * (x * x + z * z);
    const float r12 = 2.0f * (y * z - rr * x);
    const float r20 = 2.0f * (x * z - rr * y);
    const float r21 = 2.0f * (y * z + rr * x);
    const float r22 = 1.0f - 2.0f * (x * x + y * y);
    const float a = sx * sx, b = sy * sy, c = sz * sz;
    const float vxx = a * r00 * r00 + b * r01 * r01 + c * r02 * r02;
    const float vxy = a * r00 * r10 + b * r01 * r11 + c * r02 * r12;
    const float vxz = a * r00 * r20 + b * r01 * r21 + c * r02 * r22;
    const float vyy = a * r10 * r10 + b * r11 * r11 + c * r12 * r12;
    const float vyz = a * r10 * r20 + b * r11 * r21 + c * r12 * r22;
    const float vzz = a * r20 * r20 + b * r21 * r21 + c * r22 * r22;
    const float max_scale = fmaxf(fmaxf(sx, sy), sz);

    auto aff = [&](const float* mt, int col) {
      return mx * mt[col] + my * mt[4 + col] + mz * mt[8 + col] +
             mt[12 + col];
    };
    const float h0 = aff(P, 0), h1 = aff(P, 1), w = aff(P, 3);
    const float inv_w = 1.0f / (fabsf(w) < 1e-7f ? 1e-7f : w);
    const float t0 = aff(V, 0), t1 = aff(V, 1), t2 = aff(V, 2);

    // computeCov2D in _cov2d_cols' order
    const float tan_x = s_cam[35], tan_y = s_cam[36];
    const float focal_x = static_cast<float>(prm.width) / (2.0f * tan_x);
    const float focal_y = static_cast<float>(prm.height) / (2.0f * tan_y);
    const float tz = fabsf(t2) < 1e-6f ? 1e-6f : t2;
    const float limx = 1.3f * tan_x, limy = 1.3f * tan_y;
    const float tx = fminf(fmaxf(t0 / tz, -limx), limx) * tz;
    const float ty = fminf(fmaxf(t1 / tz, -limy), limy) * tz;
    const float inv_z = 1.0f / tz;
    const float inv_z2 = inv_z * inv_z;
    const float j00 = focal_x * inv_z;
    const float j02 = -focal_x * tx * inv_z2;
    const float j11 = focal_y * inv_z;
    const float j12 = -focal_y * ty * inv_z2;
    const float vm[3][3] = {{vxx, vxy, vxz}, {vxy, vyy, vyz},
                            {vxz, vyz, vzz}};
    auto vw = [&](int i, int col) {
      return vm[i][0] * V[col] + vm[i][1] * V[4 + col] +
             vm[i][2] * V[8 + col];
    };
    const float vw00 = vw(0, 0), vw01 = vw(0, 1), vw02 = vw(0, 2);
    const float vw10 = vw(1, 0), vw11 = vw(1, 1), vw12 = vw(1, 2);
    const float vw20 = vw(2, 0), vw21 = vw(2, 1), vw22 = vw(2, 2);
    auto wtvw = [&](int row, float b0, float b1, float b2) {
      return V[row] * b0 + V[4 + row] * b1 + V[8 + row] * b2;
    };
    const float ca = wtvw(0, vw00, vw10, vw20);
    const float cb = wtvw(1, vw00, vw10, vw20);
    const float cc = wtvw(2, vw00, vw10, vw20);
    const float cd = wtvw(1, vw01, vw11, vw21);
    const float ce = wtvw(2, vw01, vw11, vw21);
    const float cf = wtvw(2, vw02, vw12, vw22);
    const float cov_xx = j00 * j00 * ca + 2.0f * j00 * j02 * cc +
                         j02 * j02 * cf;
    const float cov_xy = j00 * j11 * cb + j00 * j12 * cc + j02 * j11 * ce +
                         j02 * j12 * cf;
    const float cov_yy = j11 * j11 * cd + 2.0f * j11 * j12 * ce +
                         j12 * j12 * cf;

    // project_gaussians
    const float det_orig = cov_xx * cov_yy - cov_xy * cov_xy;
    const float cxx = cov_xx + prm.dilation;
    const float cyy = cov_yy + prm.dilation;
    const float cxy = cov_xy;
    const float det = cxx * cyy - cxy * cxy;
    valid = t2 > prm.near_z && det > 0.0f;
    if (prm.big_limit != INFINITY)
      valid = valid && max_scale <= prm.big_limit;
    const float det_inv = 1.0f / (det == 0.0f ? 1.0f : det);
    float opacity = op;
    if (prm.antialiasing)
      opacity = op * sqrtf(fmaxf(det_orig * det_inv, 2.5e-5f));
    const float mid = 0.5f * (cxx + cyy);
    const float lam = mid + sqrtf(fmaxf(mid * mid - det, 0.1f));
    const float radius_f = ceilf(3.0f * sqrtf(lam));
    const float two_l = fminf(
        fmaxf(2.0f * logf(fmaxf(opacity, 1e-12f) / prm.alpha_min), 0.0f),
        20.0f);
    const float ext_x = sqrtf(two_l * fmaxf(cxx, 0.0f)) + 1e-3f;
    const float ext_y = sqrtf(two_l * fmaxf(cyy, 0.0f)) + 1e-3f;
    const float reff = sqrtf(two_l * lam) + 1e-3f;
    valid = valid && two_l > 0.0f;
    rado = valid ? static_cast<int>(radius_f) : 0;
    valid = valid && rado > 0;
    if (valid) {
      xo = ((h0 * inv_w + 1.0f) * static_cast<float>(prm.width) - 1.0f) *
           0.5f;
      yo = ((h1 * inv_w + 1.0f) * static_cast<float>(prm.height) - 1.0f) *
           0.5f;
      c0 = cyy * det_inv;
      c1 = -cxy * det_inv;
      c2 = cxx * det_inv;
      opo = opacity;
      depo = t2;
      exo = ext_x;
      eyo = ext_y;
      reffo = reff * reff;
    }

    // sh_color: the SH coefficients lerped as they are read
    constexpr int kCoef = (DEG + 1) * (DEG + 1);
    float basis[kCoef];
    basis[0] = kC0;
    if constexpr (DEG > 0) {
      const float dx = mx - s_cam[32], dy = my - s_cam[33],
                  dz = mz - s_cam[34];
      const float dinv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz + 1e-20f);
      const float ux = dx * dinv, uy = dy * dinv, uz = dz * dinv;
      basis[1] = -kC1 * uy;
      basis[2] = kC1 * uz;
      basis[3] = -kC1 * ux;
      if constexpr (DEG > 1) {
        const float xx = ux * ux, yy = uy * uy, zz = uz * uz;
        basis[4] = kC20 * ux * uy;
        basis[5] = kC21 * uy * uz;
        basis[6] = kC22 * (2.0f * zz - xx - yy);
        basis[7] = kC23 * ux * uz;
        basis[8] = kC24 * (xx - yy);
        if constexpr (DEG > 2) {
          basis[9] = kC30 * uy * (3.0f * xx - yy);
          basis[10] = kC31 * ux * uy * uz;
          basis[11] = kC32 * uy * (4.0f * zz - xx - yy);
          basis[12] = kC33 * uz * (2.0f * zz - 3.0f * xx - 3.0f * yy);
          basis[13] = kC34 * ux * (4.0f * zz - xx - yy);
          basis[14] = kC35 * uz * (xx - yy);
          basis[15] = kC36 * ux * (xx - 3.0f * yy);
        }
      }
    }
#pragma unroll
    for (int ch3 = 0; ch3 < 3; ++ch3) {
      float sum = basis[0] * at(11 + ch3);
#pragma unroll
      for (int k = 1; k < kCoef; ++k)
        sum = sum + basis[k] * at(11 + 3 * k + ch3);
      rgb[ch3] = fmaxf(sum + 0.5f, 0.0f);
    }
  }

  if (in) {
    float4* fo = prm.feats + 3 * r;
    fo[0] = float4{xo, yo, -0.5f * c0, -c1};
    fo[1] = float4{-0.5f * c2, opo, rgb[0], rgb[1]};
    fo[2] = float4{rgb[2], 1.0f / fmaxf(depo, 1e-6f), t, ik};
    prm.depth[r] = depo;
    prm.radius[r] = rado;
    prm.valid[r] = valid ? 1 : 0;
    prm.ext[r] = float2{exo, eyo};
    prm.reff2[r] = reffo;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the launch's cudaError_t. `d` is
// the table's half width in floats (11 + 3 K), so a table row is d float2;
// sh_degree 0 to 3 with (sh_degree + 1)^2 <= K.
extern "C" int lod_preprocess_launch(
    const void* table, const void* mask, const void* ts, const void* kids,
    const void* alive, const void* world_view, const void* full_proj,
    const void* campos, const void* tan_x_ptr, const void* tan_y_ptr,
    float tan_x, float tan_y, int c, int d, int n_sky, int width,
    int height, int sh_degree, float dilation, float near_z,
    float big_limit, float alpha_min, int antialiasing, void* feats,
    void* depth, void* radius, void* valid, void* ext, void* reff2,
    void* stream) {
  const int k = (d - 11) / 3;
  if (d > kMaxRowF2 || d < 11 || (d - 11) % 3 || sh_degree < 0 ||
      sh_degree > 3 || (sh_degree + 1) * (sh_degree + 1) > k || c < 0 ||
      n_sky < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = static_cast<long long>(n_sky) + c;
  if (m == 0) return static_cast<int>(cudaSuccess);
  const Params prm{static_cast<const float2*>(table),
                   static_cast<const unsigned char*>(mask),
                   static_cast<const float*>(ts),
                   static_cast<const int*>(kids),
                   static_cast<const unsigned char*>(alive),
                   static_cast<const float*>(world_view),
                   static_cast<const float*>(full_proj),
                   static_cast<const float*>(campos),
                   static_cast<const float*>(tan_x_ptr),
                   static_cast<const float*>(tan_y_ptr),
                   tan_x, tan_y, c, d, n_sky, width, height, dilation,
                   near_z, big_limit, alpha_min, antialiasing,
                   static_cast<float4*>(feats), static_cast<float*>(depth),
                   static_cast<int*>(radius),
                   static_cast<unsigned char*>(valid),
                   static_cast<float2*>(ext), static_cast<float*>(reff2)};
  decltype(&lod_preprocess_kernel<0>) kernel =
      sh_degree == 0   ? &lod_preprocess_kernel<0>
      : sh_degree == 1 ? &lod_preprocess_kernel<1>
      : sh_degree == 2 ? &lod_preprocess_kernel<2>
                       : &lod_preprocess_kernel<3>;
  const int rows_a_block = kWarps * 32;
  const int grid = static_cast<int>((m + rows_a_block - 1) / rows_a_block);
  kernel<<<grid, rows_a_block, 0, static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lod_preprocess_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
