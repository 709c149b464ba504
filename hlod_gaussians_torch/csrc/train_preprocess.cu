// Kernels train_preprocess_forward and train_preprocess_backward: the
// training step's per-row chain from the raw parameters to kernel B1's
// feature rows and the binning's inputs, and the reverse of that chain,
// one launch each.
//
// Replace no TPU kernel: the JAX package leaves this chain and its
// derivative to XLA, which fuses both (models/gaussians.py::activate,
// ops/gaussian_math.py's cov3d and projection, ops/sh.py::sh_color,
// rasterize_xla.py::blend_features). As separate PyTorch kernels the chain
// is some 400 launches forward and more in autograd's backward, each a pass
// over [C] temporaries in device memory, plus the f_dc / f_rest cat and its
// split. Plain version: hlod_gaussians_torch/ops/train_preprocess.py
// ::train_preprocess_plain, differentiated by autograd. Wrapper:
// ::train_preprocess, a torch.autograd.Function whose forward launches the
// first kernel and whose backward launches the second.
//
// What the forward computes, for row r of C where mask[r]: exp of the
// log-scales, the sigmoid of the opacity logit, the quaternion normalised
// (the activation's normalisation, then compute_cov3d's own), the 3D
// covariance, the EWA projection (near plane, det > 0, big_limit on the
// largest scale, the antialiasing opacity, radius, the tight extents of
// alpha >= alpha_min), the colour from SH of degree DEG (the first
// (DEG + 1)^2 coefficients of f_dc then f_rest, however many f_rest
// stores) and the inverse depth. Out go the [C, 12] feature rows in
// blend_features' layout (x, y, the pre-scaled conic, opacity, rgb,
// inverse depth, 1, 1), xy plus xy_offset[r] where an offset is given, and
// depth, radius, valid, ext and reff2. A culled row is sanitised as
// project_gaussians sanitises it (xy 0, conic (1, 0, 1), depth 1, opacity
// 0, radius 0, ext and reff2 0) and keeps its colour; a row outside the
// mask reads its mask byte and its offset only, and takes colour 0.
//
// What the backward computes, for row r where mask[r], from the feature
// rows' gradient g_feats[r] (columns 0-9; t and 1/kids carry none): the
// forward recomputed from the parameters (nothing is saved between the
// two launches), then its reverse, step by step in the plain chain's
// terms. A clamp or a where passes the gradient where PyTorch's does
// (clamp_min where x >= min, the clamped tx / ty inside their limits, the
// colour's clamp at 0, the near-zero w and tz guards where not taken); a
// culled row's geometry takes none, only its colour; radius, ext and reff2
// take none (the binning reads them detached). Out go the gradients of
// xyz, log_scale, quat, opacity_logit, f_dc and f_rest in their own shapes
// (f_rest's coefficients past DEG zero) and of xy_offset (g_feats' x and y
// on every row). A row outside the mask is all zeros but for xy_offset's:
// its g_feats row must be zero, as gaussian_grads leaves every row the
// binning never placed.
//
// Bound on this card: memory. At SH 3 a row's parameters are 59 float32
// (236 bytes) beside its mask byte; the forward writes 69 bytes (the
// feature row and the binning's inputs), the backward reads the 48-byte
// gradient row and writes 236 bytes of gradients and 8 of xy_offset's. The
// train cell's state (2,959,677 rows, all in the mask, xy_offset given):
// forward 314 bytes a row (0.929 GB, 0.277 ms at 3.35 TB/s), backward 529
// (1.566 GB, 0.467 ms). The post cell's (4,194,304 rows, 42 % in the mask,
// SH 1 of SH 3 stored, no offset): a row in the mask reads 23 floats, a row
// outside only its mask byte, every row writes 69 and 236 bytes; forward
// 0.46 GB (0.136 ms), backward 1.24 GB (0.370 ms). About 600 f32 operations a
// row forward and 1,500 backward at SH 3: 1.8 and 4.4 GFLOP in the train
// cell, 0.03 and 0.07 ms at 67 TFLOP/s.
//
// Design:
// - A warp takes 32 consecutive rows. One ballot names those in the mask.
//   For each input tensor the warp copies the 32 rows' span into shared
//   memory with 4-byte cp.async: the span is contiguous, so each copy
//   instruction of the warp reads 128 contiguous bytes, a row outside the
//   mask is skipped float by float, and all of the warp's copies are in
//   flight at once. f_rest is read only as far as DEG needs (9 of its 45
//   floats a row at SH 1).
// - Then each lane computes its own row from shared memory; nothing
//   intermediate reaches device memory. The forward writes the feature
//   row as three 16-byte stores. The backward writes each gradient over
//   its own row's slots in shared memory, and the warp then writes each
//   tensor's 32 rows as one contiguous run (f_rest's coefficients past DEG
//   and the rows outside the mask as zeros), so the 180-byte f_rest rows
//   leave in full 128-byte runs instead of one strided float a lane.
// - Numerics: the forward follows the plain version's column order, and
//   the source builds with -fmad=false, so no product is contracted into an
//   FMA: the discrete decisions (the near plane, det > 0, the radius ceil,
//   the extents) see the plain chain's floats on all but boundary rows.
//   Division and sqrt are IEEE (no --use_fast_math). The backward's sums
//   are taken in another order than autograd's and round differently.
//
// Budget per block: four warps; static shared memory 4 x (448 + 32 x 3 x
// ((DEG + 1)^2 - 1)) floats of staged rows (30,208 bytes at SH 3) and the
// camera.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;          // warps a block
constexpr unsigned kFull = 0xffffffffu;
// a warp's staged rows, in floats: 32 rows each of xyz, log_scale, quat,
// opacity_logit and f_dc, then f_rest's coefficients that DEG reads
constexpr int kXyz = 0, kLs = 96, kQuat = 192, kOl = 320, kDc = 352,
              kRest = 448;

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
  const float* xyz;             // [C, 3]
  const float* log_scale;       // [C, 3]
  const float* quat;            // [C, 4] (w, x, y, z)
  const float* opacity_logit;   // [C]
  const float* f_dc;            // [C, 3]
  const float* f_rest;          // [C, 3 K]
  const float2* xy_offset;      // [C], or null
  const unsigned char* mask;    // [C]
  const float* world_view;      // [4, 4], row vectors: p @ V[:3] + V[3]
  const float* full_proj;       // [4, 4]
  const float* campos;          // [3]
  const float* tan_x_ptr;       // 0-d on the device, or null: tan_x
  const float* tan_y_ptr;
  float tan_x, tan_y;
  int c, k_rest, width, height;
  float dilation, near_z, big_limit, alpha_min;
  int antialiasing;
  // forward outputs
  float4* feats;                // [C, 3] float4
  float* depth;                 // [C]
  int* radius;                  // [C]
  unsigned char* valid;         // [C]
  float2* ext;                  // [C]
  float* reff2;                 // [C]
  // backward input and outputs
  const float4* g_feats;        // [C, 3] float4
  float* g_xyz;                 // [C, 3]
  float* g_log_scale;           // [C, 3]
  float* g_quat;                // [C, 4]
  float* g_opacity_logit;       // [C]
  float* g_f_dc;                // [C, 3]
  float* g_f_rest;              // [C, 3 K]
  float2* g_xy_offset;          // [C], or null
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The first R floats of each of the warp's rows set in `rows` (rows of
// `stride` floats from `src`, the warp's first row) into s, row l at
// s + l * R.
template <int R>
__device__ __forceinline__ void stage_in(float* s, const float* src,
                                         int stride, unsigned rows,
                                         int lane) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int k = lane + 32 * i;
    const int l = k / R;
    if ((rows >> l) & 1u)
      cp_async4(s + k, src + static_cast<long long>(l) * stride + (k - l * R));
  }
}

// The warp's rows of a tensor of R floats a row from s (row l at s + l * R)
// to dst, the warp's first row, as one contiguous run: rows set in `rows`
// from s, the other rows set in `in` as zeros.
template <int R>
__device__ __forceinline__ void store_rows(float* dst, const float* s,
                                           unsigned rows, unsigned in,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int k = lane + 32 * i;
    const int l = k / R;
    if ((in >> l) & 1u) dst[k] = (rows >> l) & 1u ? s[k] : 0.0f;
  }
}

// f_rest's gradient rows of w floats from s (R floats a row): each row of
// the warp in `in` as a contiguous run, zeros past R and on the rows not
// in `rows`.
template <int R>
__device__ __forceinline__ void store_rest(float* dst, const float* s,
                                           int w, unsigned rows, unsigned in,
                                           int lane) {
  for (int l = 0; l < 32 && ((in >> l) & 1u); ++l) {
    const bool on = (rows >> l) & 1u;
    float* d = dst + static_cast<long long>(l) * w;
    for (int col = lane; col < w; col += 32)
      d[col] = on && col < R ? s[l * R + col] : 0.0f;
  }
}

// One row's forward: what the feature row needs and the intermediates its
// reverse reads.
template <int DEG>
struct Row {
  static constexpr int kCoef = (DEG + 1) * (DEG + 1);
  float m[3], s[3], qraw[4], qnorm, qn, q[4], op;
  float n2, qinv, u[4], rot[3][3];
  float h0, h1, w, inv_w, t0, t1, t2, tz, rx, ry, tx, ty, inv_z, inv_z2;
  float j00, j02, j11, j12, ca, cb, cc, cd, ce, cf;
  float cov_xx, cov_xy, cov_yy, det_orig, cxx, cyy, cxy, det_inv;
  float ratio, h_conv, opacity;
  float d[3], dinv, dir[3], basis[kCoef], sum[3];
  float ext_x, ext_y, reff;
  int radius;
  bool valid;
};

// The forward of one row in the mask from its staged parameters (xyz 3,
// log_scale 3, quat 4, the opacity logit, f_dc 3 and DEG's f_rest floats)
// and the camera in shared memory (view 0:16, projection 16:32, campos
// 32:35, tangents 35:37).
template <int DEG>
__device__ __forceinline__ void forward_row(Row<DEG>& f, const float* xyz,
                                            const float* ls, const float* qr,
                                            float ol, const float* dc,
                                            const float* rest,
                                            const float* cam,
                                            const Params& prm) {
  // models/gaussians.py::activate
  for (int k = 0; k < 3; ++k) {
    f.m[k] = xyz[k];
    f.s[k] = expf(ls[k]);
  }
  for (int k = 0; k < 4; ++k) f.qraw[k] = qr[k];
  f.qnorm = sqrtf(qr[0] * qr[0] + qr[1] * qr[1] + qr[2] * qr[2] +
                  qr[3] * qr[3]);
  f.qn = fmaxf(f.qnorm, 1e-12f);
  for (int k = 0; k < 4; ++k) f.q[k] = qr[k] / f.qn;
  f.op = 1.0f / (1.0f + expf(-ol));

  // compute_cov3d, with its own normalisation
  const float* q = f.q;
  f.n2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  f.qinv = 1.0f / sqrtf(fmaxf(f.n2, 1e-24f));
  for (int k = 0; k < 4; ++k) f.u[k] = q[k] * f.qinv;
  const float rr = f.u[0], x = f.u[1], y = f.u[2], z = f.u[3];
  f.rot[0][0] = 1.0f - 2.0f * (y * y + z * z);
  f.rot[0][1] = 2.0f * (x * y - rr * z);
  f.rot[0][2] = 2.0f * (x * z + rr * y);
  f.rot[1][0] = 2.0f * (x * y + rr * z);
  f.rot[1][1] = 1.0f - 2.0f * (x * x + z * z);
  f.rot[1][2] = 2.0f * (y * z - rr * x);
  f.rot[2][0] = 2.0f * (x * z - rr * y);
  f.rot[2][1] = 2.0f * (y * z + rr * x);
  f.rot[2][2] = 1.0f - 2.0f * (x * x + y * y);
  const float sx = f.s[0], sy = f.s[1], sz = f.s[2];
  const float a = sx * sx, b = sy * sy, c = sz * sz;
  const auto& R = f.rot;
  const float vxx = a * R[0][0] * R[0][0] + b * R[0][1] * R[0][1] +
                    c * R[0][2] * R[0][2];
  const float vxy = a * R[0][0] * R[1][0] + b * R[0][1] * R[1][1] +
                    c * R[0][2] * R[1][2];
  const float vxz = a * R[0][0] * R[2][0] + b * R[0][1] * R[2][1] +
                    c * R[0][2] * R[2][2];
  const float vyy = a * R[1][0] * R[1][0] + b * R[1][1] * R[1][1] +
                    c * R[1][2] * R[1][2];
  const float vyz = a * R[1][0] * R[2][0] + b * R[1][1] * R[2][1] +
                    c * R[1][2] * R[2][2];
  const float vzz = a * R[2][0] * R[2][0] + b * R[2][1] * R[2][1] +
                    c * R[2][2] * R[2][2];
  const float max_scale = fmaxf(fmaxf(sx, sy), sz);

  // project_gaussians
  const float* V = cam;
  const float* P = cam + 16;
  const float mx = f.m[0], my = f.m[1], mz = f.m[2];
  auto aff = [&](const float* mt, int col) {
    return mx * mt[col] + my * mt[4 + col] + mz * mt[8 + col] + mt[12 + col];
  };
  f.h0 = aff(P, 0);
  f.h1 = aff(P, 1);
  f.w = aff(P, 3);
  f.inv_w = 1.0f / (fabsf(f.w) < 1e-7f ? 1e-7f : f.w);
  f.t0 = aff(V, 0);
  f.t1 = aff(V, 1);
  f.t2 = aff(V, 2);

  // computeCov2D in _cov2d_cols' order
  const float tan_x = cam[35], tan_y = cam[36];
  const float focal_x = static_cast<float>(prm.width) / (2.0f * tan_x);
  const float focal_y = static_cast<float>(prm.height) / (2.0f * tan_y);
  f.tz = fabsf(f.t2) < 1e-6f ? 1e-6f : f.t2;
  const float limx = 1.3f * tan_x, limy = 1.3f * tan_y;
  f.rx = f.t0 / f.tz;
  f.ry = f.t1 / f.tz;
  f.tx = fminf(fmaxf(f.rx, -limx), limx) * f.tz;
  f.ty = fminf(fmaxf(f.ry, -limy), limy) * f.tz;
  f.inv_z = 1.0f / f.tz;
  f.inv_z2 = f.inv_z * f.inv_z;
  f.j00 = focal_x * f.inv_z;
  f.j02 = -focal_x * f.tx * f.inv_z2;
  f.j11 = focal_y * f.inv_z;
  f.j12 = -focal_y * f.ty * f.inv_z2;
  const float vm[3][3] = {{vxx, vxy, vxz}, {vxy, vyy, vyz},
                          {vxz, vyz, vzz}};
  auto vw = [&](int i, int col) {
    return vm[i][0] * V[col] + vm[i][1] * V[4 + col] + vm[i][2] * V[8 + col];
  };
  const float vw00 = vw(0, 0), vw01 = vw(0, 1), vw02 = vw(0, 2);
  const float vw10 = vw(1, 0), vw11 = vw(1, 1), vw12 = vw(1, 2);
  const float vw20 = vw(2, 0), vw21 = vw(2, 1), vw22 = vw(2, 2);
  auto wtvw = [&](int row, float b0, float b1, float b2) {
    return V[row] * b0 + V[4 + row] * b1 + V[8 + row] * b2;
  };
  f.ca = wtvw(0, vw00, vw10, vw20);
  f.cb = wtvw(1, vw00, vw10, vw20);
  f.cc = wtvw(2, vw00, vw10, vw20);
  f.cd = wtvw(1, vw01, vw11, vw21);
  f.ce = wtvw(2, vw01, vw11, vw21);
  f.cf = wtvw(2, vw02, vw12, vw22);
  const float j00 = f.j00, j02 = f.j02, j11 = f.j11, j12 = f.j12;
  f.cov_xx = j00 * j00 * f.ca + 2.0f * j00 * j02 * f.cc + j02 * j02 * f.cf;
  f.cov_xy = j00 * j11 * f.cb + j00 * j12 * f.cc + j02 * j11 * f.ce +
             j02 * j12 * f.cf;
  f.cov_yy = j11 * j11 * f.cd + 2.0f * j11 * j12 * f.ce + j12 * j12 * f.cf;

  f.det_orig = f.cov_xx * f.cov_yy - f.cov_xy * f.cov_xy;
  f.cxx = f.cov_xx + prm.dilation;
  f.cyy = f.cov_yy + prm.dilation;
  f.cxy = f.cov_xy;
  const float det = f.cxx * f.cyy - f.cxy * f.cxy;
  bool valid = f.t2 > prm.near_z && det > 0.0f;
  if (prm.big_limit != INFINITY) valid = valid && max_scale <= prm.big_limit;
  f.det_inv = 1.0f / (det == 0.0f ? 1.0f : det);
  f.opacity = f.op;
  f.ratio = f.det_orig * f.det_inv;
  f.h_conv = sqrtf(fmaxf(f.ratio, 2.5e-5f));
  if (prm.antialiasing) f.opacity = f.op * f.h_conv;
  const float mid = 0.5f * (f.cxx + f.cyy);
  const float lam = mid + sqrtf(fmaxf(mid * mid - det, 0.1f));
  const float radius_f = ceilf(3.0f * sqrtf(lam));
  const float two_l = fminf(
      fmaxf(2.0f * logf(fmaxf(f.opacity, 1e-12f) / prm.alpha_min), 0.0f),
      20.0f);
  f.ext_x = sqrtf(two_l * fmaxf(f.cxx, 0.0f)) + 1e-3f;
  f.ext_y = sqrtf(two_l * fmaxf(f.cyy, 0.0f)) + 1e-3f;
  f.reff = sqrtf(two_l * lam) + 1e-3f;
  valid = valid && two_l > 0.0f;
  f.radius = valid ? static_cast<int>(radius_f) : 0;
  f.valid = valid && f.radius > 0;

  // sh_color
  f.basis[0] = kC0;
  if constexpr (DEG > 0) {
    f.d[0] = mx - cam[32];
    f.d[1] = my - cam[33];
    f.d[2] = mz - cam[34];
    f.dinv = 1.0f / sqrtf(f.d[0] * f.d[0] + f.d[1] * f.d[1] +
                          f.d[2] * f.d[2] + 1e-20f);
    for (int k = 0; k < 3; ++k) f.dir[k] = f.d[k] * f.dinv;
    const float ux = f.dir[0], uy = f.dir[1], uz = f.dir[2];
    f.basis[1] = -kC1 * uy;
    f.basis[2] = kC1 * uz;
    f.basis[3] = -kC1 * ux;
    if constexpr (DEG > 1) {
      const float xx = ux * ux, yy = uy * uy, zz = uz * uz;
      f.basis[4] = kC20 * ux * uy;
      f.basis[5] = kC21 * uy * uz;
      f.basis[6] = kC22 * (2.0f * zz - xx - yy);
      f.basis[7] = kC23 * ux * uz;
      f.basis[8] = kC24 * (xx - yy);
      if constexpr (DEG > 2) {
        f.basis[9] = kC30 * uy * (3.0f * xx - yy);
        f.basis[10] = kC31 * ux * uy * uz;
        f.basis[11] = kC32 * uy * (4.0f * zz - xx - yy);
        f.basis[12] = kC33 * uz * (2.0f * zz - 3.0f * xx - 3.0f * yy);
        f.basis[13] = kC34 * ux * (4.0f * zz - xx - yy);
        f.basis[14] = kC35 * uz * (xx - yy);
        f.basis[15] = kC36 * ux * (xx - 3.0f * yy);
      }
    }
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float sum = f.basis[0] * dc[ch];
#pragma unroll
    for (int k = 1; k < Row<DEG>::kCoef; ++k)
      sum = sum + f.basis[k] * rest[3 * (k - 1) + ch];
    f.sum[ch] = sum;
  }
}

// The reverse of forward_row for the feature row's gradient g (columns
// 0-9): the gradients of the row's parameters, xyz into gm, log_scale
// into gls, quat into gq, the opacity logit into gol, f_dc into gdc and
// DEG's f_rest coefficients into grest.
template <int DEG>
__device__ __forceinline__ void backward_row(
    const Row<DEG>& f, const float* dc, const float* rest, const float* g,
    const float* cam, const Params& prm, float* gm, float* gls, float* gq,
    float& gol, float* gdc, float* grest) {
  constexpr int kCoef = Row<DEG>::kCoef;
  // the colour, max(sum + 0.5, 0), and its SH sum
  float go[3];
  for (int ch = 0; ch < 3; ++ch)
    go[ch] = f.sum[ch] + 0.5f >= 0.0f ? g[6 + ch] : 0.0f;
  for (int ch = 0; ch < 3; ++ch) gdc[ch] = f.basis[0] * go[ch];
#pragma unroll
  for (int k = 1; k < kCoef; ++k)
    for (int ch = 0; ch < 3; ++ch)
      grest[3 * (k - 1) + ch] = f.basis[k] * go[ch];
  for (int k = 0; k < 3; ++k) gm[k] = 0.0f;
  if constexpr (DEG > 0) {
    float gb[kCoef];
#pragma unroll
    for (int k = 1; k < kCoef; ++k) {
      const float* sh = rest + 3 * (k - 1);
      gb[k] = sh[0] * go[0] + sh[1] * go[1] + sh[2] * go[2];
    }
    const float x = f.dir[0], y = f.dir[1], z = f.dir[2];
    float gx = -kC1 * gb[3], gy = -kC1 * gb[1], gz = kC1 * gb[2];
    if constexpr (DEG > 1) {
      const float xx = x * x, yy = y * y, zz = z * z;
      gx = gx + kC20 * y * gb[4] - 2.0f * kC22 * x * gb[6] +
           kC23 * z * gb[7] + 2.0f * kC24 * x * gb[8];
      gy = gy + kC20 * x * gb[4] + kC21 * z * gb[5] -
           2.0f * kC22 * y * gb[6] - 2.0f * kC24 * y * gb[8];
      gz = gz + kC21 * y * gb[5] + 4.0f * kC22 * z * gb[6] +
           kC23 * x * gb[7];
      if constexpr (DEG > 2) {
        gx = gx + 6.0f * kC30 * x * y * gb[9] + kC31 * y * z * gb[10] -
             2.0f * kC32 * x * y * gb[11] - 6.0f * kC33 * x * z * gb[12] +
             kC34 * (4.0f * zz - 3.0f * xx - yy) * gb[13] +
             2.0f * kC35 * x * z * gb[14] +
             3.0f * kC36 * (xx - yy) * gb[15];
        gy = gy + 3.0f * kC30 * (xx - yy) * gb[9] + kC31 * x * z * gb[10] +
             kC32 * (4.0f * zz - xx - 3.0f * yy) * gb[11] -
             6.0f * kC33 * y * z * gb[12] - 2.0f * kC34 * x * y * gb[13] -
             2.0f * kC35 * y * z * gb[14] - 6.0f * kC36 * x * y * gb[15];
        gz = gz + kC31 * x * y * gb[10] + 8.0f * kC32 * y * z * gb[11] +
             kC33 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gb[12] +
             8.0f * kC34 * x * z * gb[13] + kC35 * (xx - yy) * gb[14];
      }
    }
    // dir = d / sqrt(d.d + 1e-20), d = mean - campos
    const float gdinv = gx * f.d[0] + gy * f.d[1] + gz * f.d[2];
    const float gs2 = -0.5f * gdinv * (f.dinv * f.dinv * f.dinv);
    gm[0] = gx * f.dinv + 2.0f * f.d[0] * gs2;
    gm[1] = gy * f.dinv + 2.0f * f.d[1] * gs2;
    gm[2] = gz * f.dinv + 2.0f * f.d[2] * gs2;
  }
  for (int k = 0; k < 3; ++k) gls[k] = 0.0f;
  for (int k = 0; k < 4; ++k) gq[k] = 0.0f;
  gol = 0.0f;
  if (!f.valid) return;     // the where()s sanitise a culled row's geometry

  const float* V = cam;
  const float* P = cam + 16;
  // the feature row: (-0.5 c0, -c1, -0.5 c2) of the conic (cyy, -cxy, cxx)
  // / det, the opacity, 1 / max(depth, 1e-6)
  const float g_c0 = -0.5f * g[2], g_c1 = -g[3], g_c2 = -0.5f * g[4];
  const float invd = 1.0f / fmaxf(f.t2, 1e-6f);
  float g_t2 = f.t2 >= 1e-6f ? -g[9] * (invd * invd) : 0.0f;
  float g_op = g[5], g_do = 0.0f, g_dinv = 0.0f;
  if (prm.antialiasing) {
    // opacity * sqrt(max(det_orig / det, 2.5e-5))
    g_op = g[5] * f.h_conv;
    const float g_ratio =
        f.ratio >= 2.5e-5f ? g[5] * f.op / (2.0f * f.h_conv) : 0.0f;
    g_do = g_ratio * f.det_inv;
    g_dinv = g_ratio * f.det_orig;
  }
  float g_cxx = g_c2 * f.det_inv;
  float g_cyy = g_c0 * f.det_inv;
  float g_cxy = -(g_c1 * f.det_inv);
  g_dinv = g_dinv + g_c0 * f.cyy - g_c1 * f.cxy + g_c2 * f.cxx;
  const float g_det = -g_dinv * (f.det_inv * f.det_inv);
  g_cxx = g_cxx + g_det * f.cyy;
  g_cyy = g_cyy + g_det * f.cxx;
  g_cxy = g_cxy - 2.0f * f.cxy * g_det;
  const float g_xx = g_cxx + g_do * f.cov_yy;
  const float g_yy = g_cyy + g_do * f.cov_xx;
  const float g_xy = g_cxy - 2.0f * f.cov_xy * g_do;

  // computeCov2D
  const float j00 = f.j00, j02 = f.j02, j11 = f.j11, j12 = f.j12;
  const float g_ca = g_xx * j00 * j00;
  const float g_cb = g_xy * j00 * j11;
  const float g_cc = g_xx * 2.0f * j00 * j02 + g_xy * j00 * j12;
  const float g_cd = g_yy * j11 * j11;
  const float g_ce = g_xy * j02 * j11 + g_yy * 2.0f * j11 * j12;
  const float g_cf = g_xx * j02 * j02 + g_xy * j02 * j12 + g_yy * j12 * j12;
  const float g_j00 = g_xx * (2.0f * j00 * f.ca + 2.0f * j02 * f.cc) +
                      g_xy * (j11 * f.cb + j12 * f.cc);
  const float g_j02 = g_xx * (2.0f * j00 * f.cc + 2.0f * j02 * f.cf) +
                      g_xy * (j11 * f.ce + j12 * f.cf);
  const float g_j11 = g_yy * (2.0f * j11 * f.cd + 2.0f * j12 * f.ce) +
                      g_xy * (j00 * f.cb + j02 * f.ce);
  const float g_j12 = g_yy * (2.0f * j11 * f.ce + 2.0f * j12 * f.cf) +
                      g_xy * (j00 * f.cc + j02 * f.cf);
  const float tan_x = cam[35], tan_y = cam[36];
  const float focal_x = static_cast<float>(prm.width) / (2.0f * tan_x);
  const float focal_y = static_cast<float>(prm.height) / (2.0f * tan_y);
  const float g_tx = g_j02 * -focal_x * f.inv_z2;
  const float g_ty = g_j12 * -focal_y * f.inv_z2;
  const float g_iz2 = g_j02 * (-focal_x * f.tx) + g_j12 * (-focal_y * f.ty);
  const float g_iz = g_j00 * focal_x + g_j11 * focal_y +
                     2.0f * f.inv_z * g_iz2;
  float g_tz = -g_iz * (f.inv_z * f.inv_z);
  // tx = clamp(t0 / tz, -limx, limx) * tz
  const float limx = 1.3f * tan_x, limy = 1.3f * tan_y;
  g_tz = g_tz + g_tx * fminf(fmaxf(f.rx, -limx), limx) +
         g_ty * fminf(fmaxf(f.ry, -limy), limy);
  const float g_rx = f.rx >= -limx && f.rx <= limx ? g_tx * f.tz : 0.0f;
  const float g_ry = f.ry >= -limy && f.ry <= limy ? g_ty * f.tz : 0.0f;
  const float g_t0 = g_rx / f.tz;
  const float g_t1 = g_ry / f.tz;
  g_tz = g_tz - (g_rx * f.t0 + g_ry * f.t1) / (f.tz * f.tz);
  if (!(fabsf(f.t2) < 1e-6f)) g_t2 = g_t2 + g_tz;
  // the mean in pixels, ((h * inv_w + 1) * size - 1) * 0.5
  const float g_p0 = 0.5f * g[0] * static_cast<float>(prm.width);
  const float g_p1 = 0.5f * g[1] * static_cast<float>(prm.height);
  const float g_h0 = g_p0 * f.inv_w, g_h1 = g_p1 * f.inv_w;
  const float g_iw = g_p0 * f.h0 + g_p1 * f.h1;
  const float g_w = fabsf(f.w) < 1e-7f ? 0.0f : -g_iw * (f.inv_w * f.inv_w);
  for (int i = 0; i < 3; ++i)
    gm[i] = gm[i] + g_h0 * P[4 * i] + g_h1 * P[4 * i + 1] +
            g_w * P[4 * i + 3] + g_t0 * V[4 * i] + g_t1 * V[4 * i + 1] +
            g_t2 * V[4 * i + 2];

  // T = W^T Sigma W (ca = T00, cb = T10, cc = T20, cd = T11, ce = T21,
  // cf = T22), so dSigma = W dT W^T
  float A[3][3], gS[3][3];
  for (int k = 0; k < 3; ++k) {
    A[k][0] = V[4 * k] * g_ca + V[4 * k + 1] * g_cb + V[4 * k + 2] * g_cc;
    A[k][1] = V[4 * k + 1] * g_cd + V[4 * k + 2] * g_ce;
    A[k][2] = V[4 * k + 2] * g_cf;
  }
  for (int k = 0; k < 3; ++k)
    for (int l = 0; l < 3; ++l)
      gS[k][l] = A[k][0] * V[4 * l] + A[k][1] * V[4 * l + 1] +
                 A[k][2] * V[4 * l + 2];
  // compute_cov3d's packed columns xx, xy, xz, yy, yz, zz
  const float gv[6] = {gS[0][0], gS[0][1] + gS[1][0], gS[0][2] + gS[2][0],
                       gS[1][1], gS[1][2] + gS[2][1], gS[2][2]};
  // Sigma_ij = sum_k D_k R_ik R_jk, D = s^2
  const auto& R = f.rot;
  float gR[3][3];
  for (int k = 0; k < 3; ++k) {
    const float dk = f.s[k] * f.s[k];
    const float r0 = R[0][k], r1 = R[1][k], r2 = R[2][k];
    const float g_dk = gv[0] * r0 * r0 + gv[1] * r0 * r1 + gv[2] * r0 * r2 +
                       gv[3] * r1 * r1 + gv[4] * r1 * r2 + gv[5] * r2 * r2;
    gR[0][k] = dk * (2.0f * gv[0] * r0 + gv[1] * r1 + gv[2] * r2);
    gR[1][k] = dk * (gv[1] * r0 + 2.0f * gv[3] * r1 + gv[4] * r2);
    gR[2][k] = dk * (gv[2] * r0 + gv[4] * r1 + 2.0f * gv[5] * r2);
    // D_k = s_k * s_k, s_k = exp(log_scale_k)
    gls[k] = g_dk * 2.0f * f.s[k] * f.s[k];
  }
  // the rotation of the unit quaternion (r, x, y, z)
  const float rr = f.u[0], x = f.u[1], y = f.u[2], z = f.u[3];
  float gu[4];
  gu[0] = 2.0f * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] -
                  x * gR[1][2] - y * gR[2][0] + x * gR[2][1]);
  gu[1] = 2.0f * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0] -
                  2.0f * x * gR[1][1] - rr * gR[1][2] + z * gR[2][0] +
                  rr * gR[2][1] - 2.0f * x * gR[2][2]);
  gu[2] = 2.0f * (-2.0f * y * gR[0][0] + x * gR[0][1] + rr * gR[0][2] +
                  x * gR[1][0] + z * gR[1][2] - rr * gR[2][0] +
                  z * gR[2][1] - 2.0f * y * gR[2][2]);
  gu[3] = 2.0f * (-2.0f * z * gR[0][0] - rr * gR[0][1] + x * gR[0][2] +
                  rr * gR[1][0] - 2.0f * z * gR[1][1] + y * gR[1][2] +
                  x * gR[2][0] + y * gR[2][1]);
  // u = q / sqrt(max(q.q, 1e-24)), then q = qraw / max(|qraw|, 1e-12)
  const float g_qinv = gu[0] * f.q[0] + gu[1] * f.q[1] + gu[2] * f.q[2] +
                       gu[3] * f.q[3];
  const float g_n2 = f.n2 >= 1e-24f
                         ? -0.5f * g_qinv * (f.qinv * f.qinv * f.qinv)
                         : 0.0f;
  float gqa[4];
  for (int k = 0; k < 4; ++k) gqa[k] = gu[k] * f.qinv + 2.0f * f.q[k] * g_n2;
  const float g_qn = -(gqa[0] * f.qraw[0] + gqa[1] * f.qraw[1] +
                       gqa[2] * f.qraw[2] + gqa[3] * f.qraw[3]) /
                     (f.qn * f.qn);
  const float g_norm = f.qnorm >= 1e-12f ? g_qn / f.qnorm : 0.0f;
  for (int k = 0; k < 4; ++k) gq[k] = gqa[k] / f.qn + g_norm * f.qraw[k];
  // op = sigmoid(logit)
  gol = g_op * (1.0f - f.op) * f.op;
}

__device__ __forceinline__ void load_camera(float* s_cam, const Params& prm) {
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
}

// Stage the warp's rows in `rows` into s; returns after the copies land.
template <int DEG>
__device__ __forceinline__ void stage_params(float* s, const Params& prm,
                                             long long base, unsigned rows,
                                             int lane) {
  constexpr int kR = 3 * (Row<DEG>::kCoef - 1);
  stage_in<3>(s + kXyz, prm.xyz + base * 3, 3, rows, lane);
  stage_in<3>(s + kLs, prm.log_scale + base * 3, 3, rows, lane);
  stage_in<4>(s + kQuat, prm.quat + base * 4, 4, rows, lane);
  stage_in<1>(s + kOl, prm.opacity_logit + base, 1, rows, lane);
  stage_in<3>(s + kDc, prm.f_dc + base * 3, 3, rows, lane);
  if constexpr (kR > 0)
    stage_in<kR>(s + kRest, prm.f_rest + base * 3 * prm.k_rest,
                 3 * prm.k_rest, rows, lane);
  cp_async_wait_all();
  __syncwarp();
}

template <int DEG>
__global__ void __launch_bounds__(kWarps * 32)
train_preprocess_forward_kernel(const Params prm) {
  constexpr int kR = 3 * (Row<DEG>::kCoef - 1);
  constexpr int kStage = kRest + 32 * kR;
  __shared__ float s_rows[kWarps * kStage];
  __shared__ float s_cam[40];
  load_camera(s_cam, prm);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * 32;
  const long long r = base + lane;
  const bool in = r < prm.c;
  const bool drawn = in && prm.mask[r] != 0;
  float* s = s_rows + warp * kStage;
  stage_params<DEG>(s, prm, base, __ballot_sync(kFull, drawn), lane);

  float xo = 0.0f, yo = 0.0f, c0 = 1.0f, c1 = 0.0f, c2 = 1.0f;
  float opo = 0.0f, depo = 1.0f, exo = 0.0f, eyo = 0.0f, reffo = 0.0f;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  int rado = 0;
  bool valid = false;
  if (drawn) {
    Row<DEG> f;
    forward_row<DEG>(f, s + kXyz + 3 * lane, s + kLs + 3 * lane,
                     s + kQuat + 4 * lane, s[kOl + lane], s + kDc + 3 * lane,
                     s + kRest + kR * lane, s_cam, prm);
    valid = f.valid;
    rado = f.radius;
    if (valid) {
      xo = ((f.h0 * f.inv_w + 1.0f) * static_cast<float>(prm.width) - 1.0f) *
           0.5f;
      yo = ((f.h1 * f.inv_w + 1.0f) * static_cast<float>(prm.height) -
            1.0f) *
           0.5f;
      c0 = f.cyy * f.det_inv;
      c1 = -f.cxy * f.det_inv;
      c2 = f.cxx * f.det_inv;
      opo = f.opacity;
      depo = f.t2;
      exo = f.ext_x;
      eyo = f.ext_y;
      reffo = f.reff * f.reff;
    }
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = fmaxf(f.sum[ch] + 0.5f, 0.0f);
  }

  if (in) {
    if (prm.xy_offset) {
      const float2 off = prm.xy_offset[r];
      xo = xo + off.x;
      yo = yo + off.y;
    }
    float4* fo = prm.feats + 3 * r;
    fo[0] = float4{xo, yo, -0.5f * c0, -c1};
    fo[1] = float4{-0.5f * c2, opo, rgb[0], rgb[1]};
    fo[2] = float4{rgb[2], 1.0f / fmaxf(depo, 1e-6f), 1.0f, 1.0f};
    prm.depth[r] = depo;
    prm.radius[r] = rado;
    prm.valid[r] = valid ? 1 : 0;
    prm.ext[r] = float2{exo, eyo};
    prm.reff2[r] = reffo;
  }
}

template <int DEG>
__global__ void __launch_bounds__(kWarps * 32)
train_preprocess_backward_kernel(const Params prm) {
  constexpr int kR = 3 * (Row<DEG>::kCoef - 1);
  constexpr int kStage = kRest + 32 * kR;
  __shared__ float s_rows[kWarps * kStage];
  __shared__ float s_cam[40];
  load_camera(s_cam, prm);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * 32;
  const long long r = base + lane;
  const bool in = r < prm.c;
  const bool drawn = in && prm.mask[r] != 0;
  const unsigned rows = __ballot_sync(kFull, drawn);
  const unsigned ins = __ballot_sync(kFull, in);
  float* s = s_rows + warp * kStage;
  stage_params<DEG>(s, prm, base, rows, lane);

  if (in && (drawn || prm.g_xy_offset)) {
    const float4* gp = prm.g_feats + 3 * r;
    const float4 g0 = gp[0];
    if (prm.g_xy_offset) prm.g_xy_offset[r] = float2{g0.x, g0.y};
    if (drawn) {
      const float4 g1 = gp[1], g2 = gp[2];
      const float g[10] = {g0.x, g0.y, g0.z, g0.w, g1.x,
                           g1.y, g1.z, g1.w, g2.x, g2.y};
      float* xyz = s + kXyz + 3 * lane;
      float* ls = s + kLs + 3 * lane;
      float* qr = s + kQuat + 4 * lane;
      float* dc = s + kDc + 3 * lane;
      float* rest = s + kRest + kR * lane;
      Row<DEG> f;
      forward_row<DEG>(f, xyz, ls, qr, s[kOl + lane], dc, rest, s_cam, prm);
      float gm[3], gls[3], gq[4], gol, gdc[3], grest[kR > 0 ? kR : 1];
      backward_row<DEG>(f, dc, rest, g, s_cam, prm, gm, gls, gq, gol, gdc,
                        grest);
      // each gradient over its own row's staged parameters
      for (int k = 0; k < 3; ++k) {
        xyz[k] = gm[k];
        ls[k] = gls[k];
        dc[k] = gdc[k];
      }
      for (int k = 0; k < 4; ++k) qr[k] = gq[k];
      s[kOl + lane] = gol;
      for (int k = 0; k < kR; ++k) rest[k] = grest[k];
    }
  }
  __syncwarp();
  store_rows<3>(prm.g_xyz + base * 3, s + kXyz, rows, ins, lane);
  store_rows<3>(prm.g_log_scale + base * 3, s + kLs, rows, ins, lane);
  store_rows<4>(prm.g_quat + base * 4, s + kQuat, rows, ins, lane);
  store_rows<1>(prm.g_opacity_logit + base, s + kOl, rows, ins, lane);
  store_rows<3>(prm.g_f_dc + base * 3, s + kDc, rows, ins, lane);
  if (prm.k_rest > 0)
    store_rest<kR>(prm.g_f_rest + base * 3 * prm.k_rest, s + kRest,
                   3 * prm.k_rest, rows, ins, lane);
}

// The launch shared by both kernels: checks, grid, the degree's template.
template <typename K0, typename K1, typename K2, typename K3>
int launch(const Params& prm, int sh_degree, K0 k0, K1 k1, K2 k2, K3 k3,
           void* stream) {
  const int rows_a_block = kWarps * 32;
  const int grid = static_cast<int>((static_cast<long long>(prm.c) +
                                     rows_a_block - 1) / rows_a_block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sh_degree == 0) {
    k0<<<grid, rows_a_block, 0, st>>>(prm);
  } else if (sh_degree == 1) {
    k1<<<grid, rows_a_block, 0, st>>>(prm);
  } else if (sh_degree == 2) {
    k2<<<grid, rows_a_block, 0, st>>>(prm);
  } else {
    k3<<<grid, rows_a_block, 0, st>>>(prm);
  }
  return static_cast<int>(cudaGetLastError());
}

// The parameters both launches take; false where the launch takes none of
// them (the caller returns cudaErrorInvalidValue).
bool make_params(Params& prm, const void* xyz, const void* log_scale,
                 const void* quat, const void* opacity_logit,
                 const void* f_dc, const void* f_rest, const void* xy_offset,
                 const void* mask, const void* world_view,
                 const void* full_proj, const void* campos,
                 const void* tan_x_ptr, const void* tan_y_ptr, float tan_x,
                 float tan_y, int c, int k_rest, int width, int height,
                 int sh_degree, float dilation, float near_z, float big_limit,
                 float alpha_min, int antialiasing) {
  if (c < 0 || sh_degree < 0 || sh_degree > 3 || k_rest < 0 ||
      (sh_degree + 1) * (sh_degree + 1) - 1 > k_rest)
    return false;
  prm = Params{};
  prm.xyz = static_cast<const float*>(xyz);
  prm.log_scale = static_cast<const float*>(log_scale);
  prm.quat = static_cast<const float*>(quat);
  prm.opacity_logit = static_cast<const float*>(opacity_logit);
  prm.f_dc = static_cast<const float*>(f_dc);
  prm.f_rest = static_cast<const float*>(f_rest);
  prm.xy_offset = static_cast<const float2*>(xy_offset);
  prm.mask = static_cast<const unsigned char*>(mask);
  prm.world_view = static_cast<const float*>(world_view);
  prm.full_proj = static_cast<const float*>(full_proj);
  prm.campos = static_cast<const float*>(campos);
  prm.tan_x_ptr = static_cast<const float*>(tan_x_ptr);
  prm.tan_y_ptr = static_cast<const float*>(tan_y_ptr);
  prm.tan_x = tan_x;
  prm.tan_y = tan_y;
  prm.c = c;
  prm.k_rest = k_rest;
  prm.width = width;
  prm.height = height;
  prm.dilation = dilation;
  prm.near_z = near_z;
  prm.big_limit = big_limit;
  prm.alpha_min = alpha_min;
  prm.antialiasing = antialiasing;
  return true;
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream`, does not
// synchronise, allocates nothing and returns the launch's cudaError_t;
// cudaErrorInvalidValue, before any launch, for a degree outside 0-3 or
// one that needs more coefficients than f_rest's k_rest (+ 1 for f_dc).
// xy_offset and g_xy_offset may be null. The common arguments are the
// parameters (contiguous float32 rows), the mask, the camera and the
// projection's settings; then the forward's outputs, or the backward's
// gradient of the feature rows and the gradients it writes.
extern "C" int train_preprocess_forward_launch(
    const void* xyz, const void* log_scale, const void* quat,
    const void* opacity_logit, const void* f_dc, const void* f_rest,
    const void* xy_offset, const void* mask, const void* world_view,
    const void* full_proj, const void* campos, const void* tan_x_ptr,
    const void* tan_y_ptr, float tan_x, float tan_y, int c, int k_rest,
    int width, int height, int sh_degree, float dilation, float near_z,
    float big_limit, float alpha_min, int antialiasing, void* feats,
    void* depth, void* radius, void* valid, void* ext, void* reff2,
    void* stream) {
  Params prm;
  if (!make_params(prm, xyz, log_scale, quat, opacity_logit, f_dc, f_rest,
                   xy_offset, mask, world_view, full_proj, campos, tan_x_ptr,
                   tan_y_ptr, tan_x, tan_y, c, k_rest, width, height,
                   sh_degree, dilation, near_z, big_limit, alpha_min,
                   antialiasing))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0) return static_cast<int>(cudaSuccess);
  prm.feats = static_cast<float4*>(feats);
  prm.depth = static_cast<float*>(depth);
  prm.radius = static_cast<int*>(radius);
  prm.valid = static_cast<unsigned char*>(valid);
  prm.ext = static_cast<float2*>(ext);
  prm.reff2 = static_cast<float*>(reff2);
  return launch(prm, sh_degree, &train_preprocess_forward_kernel<0>,
                &train_preprocess_forward_kernel<1>,
                &train_preprocess_forward_kernel<2>,
                &train_preprocess_forward_kernel<3>, stream);
}

extern "C" int train_preprocess_backward_launch(
    const void* xyz, const void* log_scale, const void* quat,
    const void* opacity_logit, const void* f_dc, const void* f_rest,
    const void* xy_offset, const void* mask, const void* world_view,
    const void* full_proj, const void* campos, const void* tan_x_ptr,
    const void* tan_y_ptr, float tan_x, float tan_y, int c, int k_rest,
    int width, int height, int sh_degree, float dilation, float near_z,
    float big_limit, float alpha_min, int antialiasing, const void* g_feats,
    void* g_xyz, void* g_log_scale, void* g_quat, void* g_opacity_logit,
    void* g_f_dc, void* g_f_rest, void* g_xy_offset, void* stream) {
  Params prm;
  if (!make_params(prm, xyz, log_scale, quat, opacity_logit, f_dc, f_rest,
                   xy_offset, mask, world_view, full_proj, campos, tan_x_ptr,
                   tan_y_ptr, tan_x, tan_y, c, k_rest, width, height,
                   sh_degree, dilation, near_z, big_limit, alpha_min,
                   antialiasing))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0) return static_cast<int>(cudaSuccess);
  prm.g_feats = static_cast<const float4*>(g_feats);
  prm.g_xyz = static_cast<float*>(g_xyz);
  prm.g_log_scale = static_cast<float*>(g_log_scale);
  prm.g_quat = static_cast<float*>(g_quat);
  prm.g_opacity_logit = static_cast<float*>(g_opacity_logit);
  prm.g_f_dc = static_cast<float*>(g_f_dc);
  prm.g_f_rest = static_cast<float*>(g_f_rest);
  prm.g_xy_offset = static_cast<float2*>(g_xy_offset);
  return launch(prm, sh_degree, &train_preprocess_backward_kernel<0>,
                &train_preprocess_backward_kernel<1>,
                &train_preprocess_backward_kernel<2>,
                &train_preprocess_backward_kernel<3>, stream);
}

extern "C" const char* train_preprocess_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
