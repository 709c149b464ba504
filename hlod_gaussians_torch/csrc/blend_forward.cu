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
// Bound on this card: operations. Per evaluated (entry, pixel) pair, i.e.
// each entry a pixel meets before its stop, about 18 f32 operations decide
// the pair (dx, dy, power, the tests, exp, op*G, T*(1-alpha)) and 9 more
// follow for an applied one, against 48 bytes read once per entry and 24
// bytes written per pixel: at the 1080p bench frame the f32 rate, not
// memory, is the floor. What that bound leaves out: the walk issues loads,
// tests and branches beside the counted operations, and the IEEE expf goes
// through the SFU, at a quarter of the FMA rate.
//
// Design (one block per tile):
// - P pixels per thread, P the largest of 4, 2, 1 that tiles the tile into
//   warp patches (launch_shape, as in blend_backward.cu; 256 threads and
//   16x8 patches at 32x32 and 8x128 tiles). A lane takes P pixels of one
//   patch row, lw apart, so the entry's feature rows are read from shared
//   memory and dy, s1*dy and s2*dy*dy are computed once for P pixels, and
//   its P independent (T, rgb, inverse depth, n_contrib) chains give the
//   walk instruction-level parallelism. For each p the warp's stores are
//   runs of lw consecutive pixels.
// - Skips that cannot change the applied set. Below the power reject =
//   log(alpha_min / opacity) - 0.05, op * exp(power) < 0.95 alpha_min, so
//   the plain version cannot apply the pair (nor with LOD, whose alpha is
//   at most op * exp(power) for t and 1/kids in [0, 1]; outside that range
//   reject is -inf). The 0.05 covers the error of the __logf in reject.
//   Per warp and batch: lane l takes the batch's entry l and tests whether
//   the ellipse power >= reject, widened by a pixel, meets the bounding box
//   of the warp's patch (its extents from the conic in closed form); one
//   ballot gives the entries the warp walks, and the rest are skipped
//   whole. That ellipse is wider than the one the tight binning already
//   cuts tiles with (2 log(op / alpha_min) against 2 (log(op / alpha_min)
//   + 0.05), 1e-3 px of margin against a pixel), and a non-finite or
//   degenerate conic is never culled. Per entry walked: the P powers
//   straight-line first; a pixel is a candidate if it is not done, power
//   <= 0 and power >= reject, on the same power bits as the plain version,
//   and only candidates reach the exp. A warp whose pixels are all done
//   stops walking, and still joins every block barrier. (A warp vote per
//   entry, before the cull, did not pay: scripts/b1_variants.py.)
// - Entries go through shared memory in batches of kBatch, in a ring of
//   kStages slots that warp 0 fills with 16-byte cp.async two batches ahead
//   of the walk (the sorted_gid load of the batch after those is in flight
//   in a register). One barrier per batch, a __syncthreads_or of "a pixel
//   of mine is live": after it batch i is resident and batch i-1's slot is
//   free, and when no pixel of the block is live the block leaves.
// - seen: the warp votes on "applied" and lane 0 stores the byte (stores of
//   the same byte from other warps and tiles are idempotent).
// - A tile whose pixel count is not a multiple of 32 runs one pixel a
//   thread in row order; the lanes past its last pixel are done from the
//   start and join every vote and barrier, as pixels outside the image do.
// - Numerics: the decision arithmetic (power, the LOD alpha, 1 - alpha,
//   T*(1-alpha)) uses the _rn intrinsics in the plain version's operation
//   order, so nvcc does not contract it into FMAs and every alpha_min and
//   t_eps decision rounds as the plain version's separate ops do; alpha
//   takes the IEEE expf and logf. Only the colour and depth sums use FMAs.
//   Kernel B2 rebuilds the applied set from n_contrib, so it depends on
//   this. No atomics: two launches give the same bits. Build without
//   --use_fast_math.
// - Tensor cores: not used. The decisions must round exactly as the plain
//   version's separate ops do; an applied pair costs only four FMAs of
//   colour, so there is no product worth batching; and the quadratic form
//   written as a matmul (moments 1, px, py, px^2, px*py, py^2 against the
//   conic) cancels badly at pixel coordinates near 1920.
//
// Budget per block: static shared memory kStages*kBatch*(48 + 4) bytes
// (5 KB). __launch_bounds__ asks for four blocks of 256 threads per SM at
// P = 4 (at most 64 registers a thread), three with LOD (at most 80), one
// block at P = 2 and P = 1. The per-thread state is 7*P + 2 registers (T,
// four sums, n_contrib and px per pixel, py and the live mask); the ptxas
// lines that chip_smoke.py prints give the real counts.
//
// scripts/b1_variants.py times this source against edited copies of it
// (P capped, row-shaped warps, no exp-free reject, no per-warp cull, a warp
// vote per entry, other occupancy, batch size and ring depth, tile order).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxP = 4;     // pixels per thread, at most
constexpr int kBatch = 32;   // entries per shared-memory batch
constexpr int kStages = 3;   // ring slots: walked, two in flight
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float4* feats;     // [N, 3] float4
  const int* sorted_gid;   // [max_dup]
  const int* tile_starts;  // [T]
  const int* tile_counts;  // [T]
  int gw, tile_w, tile_h, patch_w, width, height;
  float t_eps, alpha_min;
  float* img4;             // [4, H, W]
  float* final_t;          // [H, W]
  int* n_contrib;          // [H, W]
  unsigned char* seen;     // [N] or null
};

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

// Blocks per SM asked of ptxas: four blocks of 256 threads at P = 4, three
// with LOD (its two more transcendentals spill at four)
template <bool LOD, int P>
struct Bounds {
  static constexpr int kThreads = 1024 / P;
  static constexpr int kMinBlocks = P == 4 ? (LOD ? 3 : 4) : 1;
};

template <bool LOD, bool SEEN, int P>
__global__ void __launch_bounds__(Bounds<LOD, P>::kThreads,
                                  Bounds<LOD, P>::kMinBlocks)
blend_forward_kernel(const Params prm) {
  __shared__ float4 s_feat[kStages * kBatch * 3];    // feature rows
  __shared__ int s_gid[SEEN ? kStages * kBatch : 1];  // their Gaussians

  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int start = prm.tile_starts[tile];
  const int count = prm.tile_counts[tile];

  // this thread's pixels in the tile: lane (lx, ly) of its warp's patch of
  // ww x wh = patch_w x 32*P/patch_w pixels at (wx, wy) (lw = patch_w / P
  // lanes across) takes the P pixels (lx + p*lw, ly) of patch row ly, which
  // share dy; without a patch (patch_w 0, P 1) thread t takes pixel t in
  // row order, the threads past the tile's last pixel take none, and the
  // warp's "patch" is the tile's rows it touches
  const int lw = prm.patch_w / P;
  int x0, ly, wx, wy, ww, wh;
  if (prm.patch_w) {
    const int patches_x = prm.tile_w / prm.patch_w;
    ww = prm.patch_w;
    wh = 32 / lw;
    wx = (warp % patches_x) * ww;
    wy = (warp / patches_x) * wh;
    x0 = wx + lane % lw;
    ly = wy + lane / lw;
  } else {
    x0 = threadIdx.x % prm.tile_w;
    ly = threadIdx.x / prm.tile_w;
    ww = prm.tile_w;
    wx = 0;
    wy = warp * 32 / prm.tile_w;
    wh = (warp * 32 + 31) / prm.tile_w - wy + 1;
  }
  const int tx = (tile % prm.gw) * prm.tile_w;
  const int ty = (tile / prm.gw) * prm.tile_h;
  const int px0 = tx + x0;
  const int py = ty + ly;
  const float pyf = static_cast<float>(py);
  // the patch's first and last pixel centres
  const float wx0 = static_cast<float>(tx + wx);
  const float wx1 = static_cast<float>(tx + wx + ww - 1);
  const float wy0 = static_cast<float>(ty + wy);
  const float wy1 = static_cast<float>(ty + wy + wh - 1);
  const bool row_in = ly < prm.tile_h && py < prm.height;

  float pxf[P], T[P], cr[P], cg[P], cb[P], cd[P];
  int last[P];
  unsigned live = 0;   // bit p: pixel p lies in the image and is not done
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int px = px0 + p * lw;
    pxf[p] = static_cast<float>(px);
    T[p] = 1.0f;
    cr[p] = cg[p] = cb[p] = cd[p] = 0.0f;
    last[p] = 0;
    if (row_in && px < prm.width) live |= 1u << p;
  }
  const unsigned inside = live;

  const int nbat = (count + kBatch - 1) / kBatch;
  // warp 0: lane t loads entries t, t + 32, ... of a batch; gid_of gives
  // their sorted_gid, issue copies their rows into the batch's slot
  auto gid_of = [&](int i, int (&g)[kBatch / 32]) {
#pragma unroll
    for (int m = 0; m < kBatch / 32; ++m) {
      const int k = i * kBatch + m * 32 + lane;
      g[m] = (i < nbat && k < count) ? prm.sorted_gid[start + k] : 0;
    }
  };
  auto issue = [&](int i, const int (&g)[kBatch / 32]) {
#pragma unroll
    for (int m = 0; m < kBatch / 32; ++m) {
      const int e = m * 32 + lane;
      if (i < nbat && i * kBatch + e < count) {
        const int slot = (i % kStages) * kBatch + e;
        const float4* row = prm.feats + 3 * static_cast<size_t>(g[m]);
        cp_async16(s_feat + 3 * slot, row);
        cp_async16(s_feat + 3 * slot + 1, row + 1);
        cp_async16(s_feat + 3 * slot + 2, row + 2);
        if (SEEN) s_gid[slot] = g[m];
      }
    }
    cp_async_commit();                  // one group per batch, maybe empty
  };

  const float log_amin = logf(prm.alpha_min) - 0.05f;
  // this warp's walk of batch i, front to back, over the entries whose
  // footprint may reach its patch
  auto walk = [&](int i) {
    if (!__any_sync(kFull, live)) return;      // the warp's pixels are done
    const float4* f = s_feat + (i % kStages) * kBatch * 3;
    const int base = i * kBatch;
    const int nb = min(kBatch, count - base);
#pragma unroll
    for (int m = 0; m < kBatch / 32; ++m) {
      // lane l takes entry e = 32m + l of the batch: below its power
      // `reject` op * exp(power) < 0.95 alpha_min, so no pixel there can
      // apply it (with LOD too, where the LOD alpha is at most op *
      // exp(power): t and 1/kids in [0, 1]; elsewhere reject is -inf);
      // the entry is skipped where that ellipse, widened by a pixel, misses
      // the patch (|dx| <= sqrt(4 reject s2 / (4 s0 s2 - s1^2)) on it)
      const int e = m * 32 + lane;
      float rej = 0.0f;
      bool touch = false;
      if (e < nb) {
        const float4 a = f[3 * e];             // x, y, s0, s1
        const float4 b = f[3 * e + 1];         // s2, opacity, r, g
        rej = log_amin - __logf(b.y);
        if (LOD) {
          const float4 c = f[3 * e + 2];       // b, invdepth, t, 1/kids
          if (!(c.z >= 0.0f && c.z <= 1.0f && c.w >= 0.0f && c.w <= 1.0f))
            rej = -INFINITY;
        }
        touch = !(rej > 0.0f);     // else power <= 0 < reject everywhere
        const float det = 4.0f * a.z * b.x - a.w * a.w;
        if (rej < 0.0f && det > 0.0f) {
          const float q = 4.0f * rej / det;
          const float ex = sqrtf(q * b.x) + 1.0f;
          const float ey = sqrtf(q * a.z) + 1.0f;
          touch = !(a.x + ex < wx0 || a.x - ex > wx1 || a.y + ey < wy0 ||
                    a.y - ey > wy1);
        }
      }
      unsigned todo = __ballot_sync(kFull, touch);
      while (todo) {
        const int l = __ffs(todo) - 1;
        todo &= todo - 1;
        const int j = m * 32 + l;
        const float4 a = f[3 * j];
        const float4 b = f[3 * j + 1];
        const float reject = __shfl_sync(kFull, rej, l);
        // the parts of power that depend on dy only, in the plain
        // version's operation order
        const float dy = __fsub_rn(a.y, pyf);
        const float s1dy = __fmul_rn(a.w, dy);
        const float s2dy2 = __fmul_rn(__fmul_rn(b.x, dy), dy);
        // straight-line first: power at the P pixels and which of them may
        // apply the entry
        float powers[P];
        unsigned cand = 0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float dx = __fsub_rn(a.x, pxf[p]);
          powers[p] = __fadd_rn(
              __fmul_rn(dx, __fadd_rn(__fmul_rn(a.z, dx), s1dy)), s2dy2);
          if (!(powers[p] > 0.0f) && !(powers[p] < reject)) cand |= 1u << p;
        }
        cand &= live;
        bool applied = false;
        if (cand) {
          const float4 c = f[3 * j + 2];
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if (!(cand >> p & 1u)) continue;
            float alpha = fminf(0.99f, __fmul_rn(b.y, expf(powers[p])));
            if (LOD) {
              const float pw = expf(__fmul_rn(
                  c.w, logf(fmaxf(__fsub_rn(1.0f, alpha), 1e-12f))));
              alpha = __fadd_rn(__fmul_rn(c.z, alpha),
                                __fmul_rn(__fsub_rn(1.0f, c.z),
                                          __fsub_rn(1.0f, pw)));
            }
            if (alpha < prm.alpha_min) continue;
            const float test_t = __fmul_rn(T[p], __fsub_rn(1.0f, alpha));
            if (test_t < prm.t_eps) {          // done; the entry is dropped
              live &= ~(1u << p);
              continue;
            }
            const float w = __fmul_rn(alpha, T[p]);
            cr[p] += w * b.z;
            cg[p] += w * b.w;
            cb[p] += w * c.x;
            cd[p] += w * c.y;
            T[p] = test_t;
            last[p] = base + j + 1;
            applied = true;
          }
        }
        if (SEEN && __any_sync(kFull, applied) && lane == 0)
          prm.seen[s_gid[(i % kStages) * kBatch + j]] = 1;
      }
    }
  };

  int gid_next[kBatch / 32] = {};
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      gid_of(i, gid_next);
      issue(i, gid_next);
    }
    gid_of(kStages - 1, gid_next);
  }
  for (int i = 0; i < nbat; ++i) {
    if (warp == 0) cp_async_wait<kStages - 2>();   // batch i has landed
    if (!__syncthreads_or(live != 0)) break;       // the block is done
    if (warp == 0) {
      issue(i + kStages - 1, gid_next);            // into batch i-1's slot
      gid_of(i + kStages, gid_next);
    }
    walk(i);
  }
  if (warp == 0) cp_async_wait<0>();   // no copy lands after the block

  const size_t hw = static_cast<size_t>(prm.width) * prm.height;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (!(inside >> p & 1u)) continue;
    const size_t pix = static_cast<size_t>(py) * prm.width + px0 + p * lw;
    prm.img4[pix] = cr[p];
    prm.img4[hw + pix] = cg[p];
    prm.img4[2 * hw + pix] = cb[p];
    prm.img4[3 * hw + pix] = cd[p];
    prm.final_t[pix] = T[p];
    prm.n_contrib[pix] = last[p];
  }
}

// Pixels per thread and the warp patch width for a tile shape (the tile's
// pixel count a multiple of 32, at most 1024): P is the largest of 4, 2, 1
// (at most kMaxP) for which the tile splits into warp patches of pw x
// 32*P/pw pixels with pw | tile_w, 32*P/pw | tile_h and P | pw (a lane's P
// pixels lie in one patch row, pw/P lanes across); the patch is the
// squarest such (wider on a tie). P = 1 with pw = gcd(tile_w, 32) always
// qualifies. The same rule as blend_backward.cu's.
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

template <bool LOD, bool SEEN>
cudaError_t launch(int p, int num_tiles, int nthr, const Params& prm,
                   cudaStream_t stream) {
  decltype(&blend_forward_kernel<LOD, SEEN, 1>) kernel =
      p == 4   ? &blend_forward_kernel<LOD, SEEN, 4>
      : p == 2 ? &blend_forward_kernel<LOD, SEEN, 2>
               : &blend_forward_kernel<LOD, SEEN, 1>;
  kernel<<<num_tiles, nthr, 0, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns the launch's cudaError_t. Tiles
// of 1 to 1024 pixels: a pixel count that is a multiple of 32 runs
// launch_shape's P pixels a thread, any other one pixel a thread with the
// last warp partial.
extern "C" int blend_forward_launch(
    const void* feats, const void* sorted_gid, const void* tile_starts,
    const void* tile_counts, int num_tiles, int gw, int tile_w, int tile_h,
    int width, int height, float t_eps, float alpha_min, int use_lod,
    void* img4, void* final_t, void* n_contrib, void* seen, void* stream) {
  const int npix = tile_w * tile_h;
  if (tile_w <= 0 || tile_h <= 0 || npix > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  int p = 1, patch_w = 0;
  if (npix % 32 == 0) launch_shape(tile_w, tile_h, &p, &patch_w);
  const int nthr = (npix / p + 31) / 32 * 32;
  const Params prm{static_cast<const float4*>(feats),
                   static_cast<const int*>(sorted_gid),
                   static_cast<const int*>(tile_starts),
                   static_cast<const int*>(tile_counts),
                   gw, tile_w, tile_h, patch_w, width, height, t_eps,
                   alpha_min, static_cast<float*>(img4),
                   static_cast<float*>(final_t),
                   static_cast<int*>(n_contrib),
                   static_cast<unsigned char*>(seen)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      use_lod ? (seen ? launch<true, true>(p, num_tiles, nthr, prm, s)
                      : launch<true, false>(p, num_tiles, nthr, prm, s))
              : (seen ? launch<false, true>(p, num_tiles, nthr, prm, s)
                      : launch<false, false>(p, num_tiles, nthr, prm, s));
  return static_cast<int>(err);
}

extern "C" const char* blend_forward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
