// Kernel sparse_adam: one masked Adam step over every trainable tensor of
// a Gaussian state in one launch, out of place.
//
// Replaces no TPU kernel: the JAX package leaves the update
// (hlod_gaussians_tpu/optim.py::sparse_adam_update) to XLA, which fuses
// it. The port's plain version is hlod_gaussians_torch/optim.py
// ::sparse_adam_plain, about 17 PyTorch kernels a tensor, each reading and
// writing whole [C, width] tensors. The reference fuses it as the
// alt-rasterizer's adamUpdateCUDA (adam.cu:9-38). Wrapper:
// optim.py::sparse_adam_cuda.
//
// What it computes, for each segment (one tensor of p, g, m, v and its
// outputs) and each element e of row r = e / width: where the segment has
// no mask or mask[r] is set,
//   m1 = m * b1 + g * (1 - b1)
//   v1 = v * b2 + (g * (1 - b2)) * g
//   p1 = p - ((m1 * (1 / bc1)) * lr) / (sqrt(v1 * (1 / bc2)) + eps)
// and elsewhere p, m and v copied bit for bit, g not read. That is the
// plain chain's arithmetic on the card op by op: PyTorch divides a tensor
// by a host scalar as a product with the scalar's float32 reciprocal, so
// the wrapper passes 1 / bc1 and 1 / bc2; every other step rounds once
// (the _rn intrinsics, and the source builds with -fmad=false), and the
// tensor division and the sqrt are IEEE. So the outputs equal the chain's
// bit for bit.
//
// Bound on this card: memory. An updated float reads p, g, m and v and
// writes p, m and v, 28 bytes; a row adds its mask byte. At 59 floats a
// row (SH 3) that is 1,653 bytes, 2.07 ms over 4,194,304 rows at 3.35 TB/s;
// a row outside the mask skips g, 1,417 bytes. About 13 f32 operations an
// element are far below the ridge.
//
// Design:
// - One launch over up to kMaxSeg segments (a Gaussian state has seven
//   tensors), the table passed by value as a kernel argument (no device
//   copy of pointers). Each block belongs to one segment: the segments'
//   blocks are laid end to end and a block finds its own by a scan of
//   kMaxSeg starts.
// - A thread takes 4 consecutive floats of the flat [C * width] tensor,
//   with 16-byte loads and stores where the pointers are 16-byte aligned
//   (a segment's last thread and unaligned segments go float by float).
//   Neighbouring threads touch neighbouring 16 bytes, so every warp
//   instruction moves 512 contiguous bytes.
// - An input may have rows further apart than their width: autograd hands
//   f_dc's and f_rest's gradients over as views of one [C, 16, 3] tensor,
//   and the out-of-core trainer its p, m and v as column views of one
//   packed [K, D] matrix. Such an input is read float by float at
//   row * stride + col, still coalesced within a row; the outputs are
//   always packed.
// - The row of the first float is one 32-bit division (a segment holds
//   fewer than 2^32 floats: 4,194,304 rows of f_rest are 189 M); the
//   others step from it. The mask bytes of the thread's rows
//   come from L1. Only a thread with a row in the mask loads g.
// - Every loop over the thread's 4 floats unrolls, so they stay in
//   registers (ptxas: no stack frame).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSeg = 8;          // segments a launch
constexpr int kThreads = 256;       // threads a block
constexpr int kPerThread = 4;       // floats a thread

enum { kP, kG, kM, kV };            // the inputs, in Seg::in and ::stride

struct Seg {
  const float* in[4];               // p, g, m, v
  float* out[3];                    // p, m, v: packed, [n / width, width]
  const unsigned char* mask;        // one byte a row, or null: every row
  unsigned long long n;             // floats
  unsigned long long stride[4];     // floats from one row of an input to
                                    // the next (width where packed)
  unsigned width;                   // floats a row
  unsigned block0;                  // the segment's first block
  float lr;
  int vec;                          // p, m, v packed, all 16-byte aligned
  int g_vec;                        // g packed and 16-byte aligned
};

struct Args {
  Seg seg[kMaxSeg];
  int n_seg;
  float b1, b2, one_m_b1, one_m_b2, inv_bc1, inv_bc2, eps;
};

__device__ __forceinline__ void adam(const Args& a, float lr, float p,
                                     float g, float m, float v, float& p1,
                                     float& m1, float& v1) {
  m1 = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(g, a.one_m_b1));
  v1 = __fadd_rn(__fmul_rn(v, a.b2),
                 __fmul_rn(__fmul_rn(g, a.one_m_b2), g));
  const float step = __fmul_rn(__fmul_rn(m1, a.inv_bc1), lr);
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v1, a.inv_bc2)), a.eps);
  p1 = __fsub_rn(p, __fdiv_rn(step, den));
}

__device__ __forceinline__ void unpack(const float4 q, float* x) {
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}

__device__ __forceinline__ float4 pack(const float* x) {
  return make_float4(x[0], x[1], x[2], x[3]);
}

__global__ void __launch_bounds__(kThreads) sparse_adam_kernel(const Args a) {
  const unsigned b = blockIdx.x;
  int s = 0;
  while (s + 1 < a.n_seg && b >= a.seg[s + 1].block0) ++s;
  const Seg& sg = a.seg[s];
  const unsigned long long e0 =
      (static_cast<unsigned long long>(b - sg.block0) * kThreads +
       threadIdx.x) * kPerThread;
  if (e0 >= sg.n) return;
  const int cnt = sg.n - e0 < kPerThread ? static_cast<int>(sg.n - e0)
                                         : kPerThread;

  // each of the thread's floats: its row and column, and whether its row
  // takes the step
  unsigned long long row[kPerThread];
  unsigned col[kPerThread];
  const unsigned e = static_cast<unsigned>(e0);
  row[0] = e / sg.width;
  col[0] = e - static_cast<unsigned>(row[0]) * sg.width;
#pragma unroll
  for (int j = 1; j < kPerThread; ++j) {
    const bool wrap = col[j - 1] + 1 == sg.width;
    row[j] = row[j - 1] + wrap;
    col[j] = wrap ? 0 : col[j - 1] + 1;
  }
  bool take[kPerThread];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    take[j] = j < cnt && (sg.mask == nullptr || sg.mask[row[j]] != 0);
    any = any || take[j];
  }
  auto at = [&](int t, int j) {
    return sg.in[t][row[j] * sg.stride[t] + col[j]];
  };

  float p[kPerThread], g[kPerThread] = {}, m[kPerThread], v[kPerThread];
  const bool vec = sg.vec && cnt == kPerThread;
  if (vec) {
    unpack(*reinterpret_cast<const float4*>(sg.in[kP] + e0), p);
    unpack(*reinterpret_cast<const float4*>(sg.in[kM] + e0), m);
    unpack(*reinterpret_cast<const float4*>(sg.in[kV] + e0), v);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (j >= cnt) break;
      p[j] = at(kP, j);
      m[j] = at(kM, j);
      v[j] = at(kV, j);
    }
  }
  if (any && vec && sg.g_vec) {
    unpack(*reinterpret_cast<const float4*>(sg.in[kG] + e0), g);
  } else if (any) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (take[j]) g[j] = at(kG, j);
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    if (take[j]) adam(a, sg.lr, p[j], g[j], m[j], v[j], p[j], m[j], v[j]);
  if (vec) {
    *reinterpret_cast<float4*>(sg.out[0] + e0) = pack(p);
    *reinterpret_cast<float4*>(sg.out[1] + e0) = pack(m);
    *reinterpret_cast<float4*>(sg.out[2] + e0) = pack(v);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (j >= cnt) break;
      sg.out[0][e0 + j] = p[j];
      sg.out[1][e0 + j] = m[j];
      sg.out[2][e0 + j] = v[j];
    }
  }
}

}  // namespace

// ptrs: 8 a segment (p, g, m, v, p_out, m_out, v_out, mask or null);
// numel, width and lr: one a segment; strides: 4 a segment (p, g, m, v).
// One launch on `stream`, none where every segment is empty. Returns
// cudaErrorInvalidValue, before any launch, for more than kMaxSeg
// segments, a segment of 2^32 floats or more, or a stride below its
// width; else the launch error, 0 on success.
extern "C" int sparse_adam_launch(int n_seg, const void* const* ptrs,
                                  const long long* numel, const int* width,
                                  const long long* strides, const float* lr,
                                  float b1, float b2, float one_m_b1,
                                  float one_m_b2, float inv_bc1,
                                  float inv_bc2, float eps, void* stream) {
  if (n_seg < 0 || n_seg > kMaxSeg)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long kPerBlock = static_cast<long long>(kThreads) * kPerThread;
  Args a{};
  a.b1 = b1;
  a.b2 = b2;
  a.one_m_b1 = one_m_b1;
  a.one_m_b2 = one_m_b2;
  a.inv_bc1 = inv_bc1;
  a.inv_bc2 = inv_bc2;
  a.eps = eps;
  long long blocks = 0;
  for (int i = 0; i < n_seg; ++i) {
    const long long* st = strides + 4 * i;
    if (numel[i] < 0 || numel[i] > 0xffffffffLL || width[i] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int t = 0; t < 4; ++t)
      if (st[t] < width[i]) return static_cast<int>(cudaErrorInvalidValue);
    if (numel[i] == 0) continue;
    const void* const* q = ptrs + 8 * i;
    auto aligned = [](const void* x) {
      return reinterpret_cast<unsigned long long>(x) % 16 == 0;
    };
    int vec = st[kP] == width[i] && st[kM] == width[i] && st[kV] == width[i];
    for (int k = 0; k < 7; ++k)
      if (k != kG) vec = vec && aligned(q[k]);
    Seg& sg = a.seg[a.n_seg++];
    for (int t = 0; t < 4; ++t) {
      sg.in[t] = static_cast<const float*>(q[t]);
      sg.stride[t] = static_cast<unsigned long long>(st[t]);
    }
    for (int t = 0; t < 3; ++t)
      sg.out[t] = static_cast<float*>(const_cast<void*>(q[4 + t]));
    sg.mask = static_cast<const unsigned char*>(q[7]);
    sg.n = static_cast<unsigned long long>(numel[i]);
    sg.width = static_cast<unsigned>(width[i]);
    sg.block0 = static_cast<unsigned>(blocks);
    sg.lr = lr[i];
    sg.vec = vec;
    sg.g_vec = aligned(q[kG]) && st[kG] == width[i];
    blocks += (numel[i] + kPerBlock - 1) / kPerBlock;
  }
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  sparse_adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sparse_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
