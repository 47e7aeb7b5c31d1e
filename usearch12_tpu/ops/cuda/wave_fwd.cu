// The banded anti-diagonal DP (ops/wavefront_nw.py) as two CUDA kernels
// called through XLA's FFI: the forward pass (WaveFwd) and the traceback
// (WaveTrace).  Same frame, same float32 op order and the same results as
// the lax formulation (_make_forward, _make_traceback), except the
// traceback tensor's layout: tb[w][p][u] (pair-major), so that one warp
// stores its pair's W + 1 words contiguously.
//
// Forward: one warp per pair.  Lane k holds the C consecutive frame lanes
// u = k*C .. k*C + C - 1 (C = 1, 2, 4, 8 for W <= 32, 64, 128, 256), with
// the band state in registers for the whole loop; the lane shifts of the
// recurrence are __shfl_up/down_sync across the lane boundary.  Each warp
// runs only as many steps as its own pair needs (la + lb).
//
// Build without fast-math and with --fmad=false: the DP is float32 adds,
// compares and selects, and must stay bit-exact with align/oracle.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float NEG = -9e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TB_DM = 1, TB_IM = 2, TB_MD = 4, TB_MI = 8;
constexpr int OP_M = 0, OP_D = 1, OP_I = 2, OP_PAD = 3;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <int C>
__global__ void wave_fwd_kernel(const int8_t* __restrict__ a,    // (P, L)
                                const int8_t* __restrict__ b,    // (P, L)
                                const int32_t* __restrict__ geo,  // (4, P)
                                const float* __restrict__ term,   // (8, P)
                                const float* __restrict__ scal,   // (6,)
                                int L, int P, int W,
                                int32_t* __restrict__ tb,  // (nw, P, W+1)
                                float* __restrict__ fin) {  // (3, P)
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= P) return;  // whole warps only: blockDim is a multiple of 32
  const int la = geo[p], lb = geo[P + p], dlo = geo[2 * P + p],
            bw = geo[3 * P + p];
  const float l_open_a = term[p], l_ext_a = term[P + p],
              l_open_b = term[2 * P + p], l_ext_b = term[3 * P + p],
              r_open_a = term[4 * P + p], r_ext_a = term[5 * P + p],
              r_open_b = term[6 * P + p], r_ext_b = term[7 * P + p];
  const float open_a_s = scal[0], ext_a_s = scal[1], open_b_s = scal[2],
              ext_b_s = scal[3], match = scal[4], mismatch = scal[5];
  const int8_t* ap = a + (size_t)p * L;
  const int8_t* bp = b + (size_t)p * L;
  const int r0 = (la - dlo) & 1;
  const int sj = min(max(dlo - 1, 0), lb - 1);
  const int u0 = lane * C;

  float m1[C], m2[C], d[C], is[C];
#pragma unroll
  for (int c = 0; c < C; ++c) m1[c] = m2[c] = d[c] = is[c] = NEG;
  float ml = NEG, i1 = NEG, fin_m = NEG, fin_d = NEG;

  const int n_words = (la + lb + 7) >> 3;
  for (int w = 0; w < n_words; ++w) {
    uint32_t acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0;
    uint32_t facc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int t = w * 8 + k;
      const int rho = (r0 + t) & 1;
      const int I0 = (la + t - dlo - rho) >> 1;
      const int J0 = t - I0;
      const int umax = (bw - 1 - rho) >> 1;
      // neighbours' edge cells for the shifts (NEG past the frame ends)
      float d_next = __shfl_down_sync(FULL, d[0], 1);
      float i_prev = __shfl_up_sync(FULL, is[C - 1], 1);
      if (lane == 31) d_next = NEG;
      if (lane == 0) i_prev = NEG;
      float nm[C], nd[C], ni[C];
      float m_last = NEG, d_lb = NEG;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int u = u0 + c;
        const int ii = I0 - u, jj = J0 + u;
        const bool in_w = u < W;
        const bool valid = in_w && ii >= 0 && ii < la && jj >= 0 && jj < lb &&
                           u <= umax;
        const float d_up = (c + 1 < C) ? d[c + 1] : d_next;
        const float i_dn = (c > 0) ? is[c - 1] : i_prev;
        const float d_in = rho ? d_up : d[c];
        const float i_in = rho ? is[c] : i_dn;
        const float m_in = (ii == 0 && jj == 0) ? 0.0f : m2[c];
        const int av = ap[min(max(ii, 0), L - 1)];
        const int bv = bp[min(max(jj, 0), L - 1)];
        const float sub =
            (av < 4 && bv < 4) ? (av == bv ? match : mismatch) : 0.0f;
        const float open_a = ii == 0 ? l_open_a : open_a_s;
        const float ext_a = ii == 0 ? l_ext_a : ext_a_s;
        const float open_b = jj == 0 ? l_open_b : open_b_s;
        const float ext_b = jj == 0 ? l_ext_b : ext_b_s;
        // MATCH: priority M over D over I
        const bool take_d = d_in > m_in;
        float xm = take_d ? d_in : m_in;
        const bool take_i = i_in > xm;
        xm = take_i ? i_in : xm;
        const float m_out = valid ? __fadd_rn(xm, sub) : NEG;
        // DELETE and INSERT: >= favours the open
        const float md = __fadd_rn(m_in, open_b);
        const float de = __fadd_rn(d_in, ext_b);
        const bool take_open = md >= de;
        const float mi = __fadd_rn(m_in, open_a);
        const float ie = __fadd_rn(i_in, ext_a);
        const bool take_iopen = mi >= ie;
        // right-terminal column Drow[LB]: cell (i, lb), every row
        const bool upd = in_w && jj == lb && ii >= 0 && ii < la;
        const float md_lb = __fadd_rn(m_in, r_open_b);
        const float de_lb = __fadd_rn(d_in, r_ext_b);
        const bool take_lb = md_lb >= de_lb;
        nm[c] = m_out;
        ni[c] = valid ? (take_iopen ? mi : ie) : NEG;
        nd[c] = valid ? (take_open ? md : de)
                      : (upd ? (take_lb ? md_lb : de_lb) : NEG);
        int bits = take_i ? TB_IM : (take_d ? TB_DM : 0);
        bits |= (take_open ? TB_MD : 0) | (take_iopen ? TB_MI : 0);
        bits = valid ? bits : ((upd && take_lb) ? TB_MD : 0);
        acc[c] |= (uint32_t)bits << (4 * k);
        if (valid && ii == la - 1) m_last = fmaxf(m_last, m_out);
        if (upd) d_lb = fmaxf(d_lb, nd[c]);
      }
      // final DPI row, column jl: needs M(la-1, jl-1) from the step
      // before (ml); every lane keeps the same per-pair scalars
      const int jl = t - (la - 1);
      const bool in_rng = jl >= sj && jl < lb;
      const float mi_l = __fadd_rn(jl > sj ? ml : NEG, r_open_a);
      const float i1e = __fadd_rn(i1, r_ext_a);
      const bool take_l = mi_l > i1e;
      if (in_rng) i1 = take_l ? mi_l : i1e;
      facc |= (uint32_t)((in_rng && take_l) ? TB_MI : 0) << (4 * k);
      ml = warp_max(m_last);
      if (jl == lb - 1) fin_m = ml;
      const float dl = warp_max(d_lb);
      if (t == la - 1 + lb) fin_d = dl;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        m2[c] = m1[c];
        m1[c] = nm[c];
        d[c] = nd[c];
        is[c] = ni[c];
      }
    }
    int32_t* row = tb + ((size_t)w * P + p) * (W + 1);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (u0 + c < W) row[u0 + c] = (int32_t)acc[c];
    if (lane == 0) row[W] = (int32_t)facc;
  }
  if (lane == 0) {
    fin[p] = fin_m;
    fin[P + p] = fin_d;
    fin[2 * P + p] = i1;
  }
}

template <int C>
void launch(cudaStream_t s, const int8_t* a, const int8_t* b,
            const int32_t* geo, const float* term, const float* scal, int L,
            int P, int W, int32_t* tb, float* fin) {
  constexpr int kThreads = 128;  // four pairs per block
  const int blocks = (P * 32 + kThreads - 1) / kThreads;
  wave_fwd_kernel<C><<<blocks, kThreads, 0, s>>>(a, b, geo, term, scal, L, P,
                                                  W, tb, fin);
}

ffi::Error WaveFwdImpl(cudaStream_t stream, ffi::Buffer<ffi::S8> a,
                       ffi::Buffer<ffi::S8> b, ffi::Buffer<ffi::S32> geo,
                       ffi::Buffer<ffi::F32> term, ffi::Buffer<ffi::F32> scal,
                       ffi::ResultBuffer<ffi::S32> tb,
                       ffi::ResultBuffer<ffi::F32> fin, int32_t W) {
  const auto dims = a.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("a: (P, L)");
  const int P = (int)dims[0], L = (int)dims[1];
  const auto tdims = tb->dimensions();
  if (tdims.size() != 3 || (int)tdims[1] != P || (int)tdims[2] != W + 1 ||
      (int)tdims[0] * 8 < 2 * L)
    return ffi::Error::InvalidArgument("tb: (n_words >= L/4, P, W + 1)");
  const int8_t* pa = a.typed_data();
  const int8_t* pb = b.typed_data();
  const int32_t* pg = geo.typed_data();
  const float* pt = term.typed_data();
  const float* ps = scal.typed_data();
  int32_t* ptb = tb->typed_data();
  float* pf = fin->typed_data();
  if (W <= 32)
    launch<1>(stream, pa, pb, pg, pt, ps, L, P, W, ptb, pf);
  else if (W <= 64)
    launch<2>(stream, pa, pb, pg, pt, ps, L, P, W, ptb, pf);
  else if (W <= 128)
    launch<4>(stream, pa, pb, pg, pt, ps, L, P, W, ptb, pf);
  else if (W <= 256)
    launch<8>(stream, pa, pb, pg, pt, ps, L, P, W, ptb, pf);
  else
    return ffi::Error::InvalidArgument("W > 256");
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}


// Traceback: one thread per pair walks its own bits from (la, lb) to
// (0, 0), one dependent load of the (L2-resident) tensor per step, and
// writes the 2-bit ops end first, four per byte, OP_PAD after the end.
__global__ void wave_trace_kernel(const int32_t* __restrict__ tb,
                                  const int32_t* __restrict__ geo,
                                  const float* __restrict__ fin, int P,
                                  int W, int n_words, int nb,
                                  float* __restrict__ scores,
                                  uint8_t* __restrict__ ops) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int la = geo[p], lb = geo[P + p], dlo = geo[2 * P + p],
            bw = geo[3 * P + p];
  const int r0 = (la - dlo) & 1;
  const size_t s_w = (size_t)P * (W + 1);
  const int32_t* tbp = tb + (size_t)p * (W + 1);
  auto nib = [&](int t, int lane) -> int {
    t = min(max(t, 0), 8 * n_words - 1);
    return (tbp[(t >> 3) * s_w + lane] >> ((t & 7) * 4)) & 15;
  };
  auto bits_at = [&](int i, int j) -> int {
    const int t = i + j;
    if (i == la) return nib(t - 1, W);
    const int I0 = (la + t - dlo - ((r0 + t) & 1)) >> 1;
    if (j == lb) {
      const int u = lb - (t - I0);
      return (u >= 0 && u < W) ? nib(t, u) : TB_MD;
    }
    const int k = j - (dlo + i - la);
    if (k == -1) return TB_IM;
    if (k < 0 || k >= bw) return 0;
    return nib(t, I0 - i);
  };
  const float fin_m = fin[p], fin_d = fin[P + p], fin_i = fin[2 * P + p];
  float score = fin_m;
  int st = OP_M;
  if (fin_d > score) { score = fin_d; st = OP_D; }
  if (fin_i > score) { score = fin_i; st = OP_I; }
  scores[p] = score;
  uint8_t* out = ops + (size_t)p * nb;
  int i = la, j = lb, s = 0;
  uint32_t byte = 0;
  while (!(i == 0 && j == 0) && s < 4 * nb) {
    byte |= (uint32_t)st << (2 * (s & 3));
    if ((s & 3) == 3) { out[s >> 2] = (uint8_t)byte; byte = 0; }
    ++s;
    if (st == OP_M) {
      const int b = bits_at(i - 1, j - 1);
      st = (b & TB_DM) ? OP_D : ((b & TB_IM) ? OP_I : OP_M);
      --i; --j;
    } else if (st == OP_D) {
      st = (bits_at(i - 1, j) & TB_MD) ? OP_M : OP_D;
      --i;
    } else {
      st = (bits_at(i, j - 1) & TB_MI) ? OP_M : OP_I;
      --j;
    }
  }
  for (; s < 4 * nb; ++s) {
    byte |= (uint32_t)OP_PAD << (2 * (s & 3));
    if ((s & 3) == 3) { out[s >> 2] = (uint8_t)byte; byte = 0; }
  }
}

ffi::Error WaveTraceImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> tb,
                         ffi::Buffer<ffi::S32> geo, ffi::Buffer<ffi::F32> fin,
                         ffi::ResultBuffer<ffi::F32> scores,
                         ffi::ResultBuffer<ffi::U8> ops, int32_t W) {
  const auto tdims = tb.dimensions();
  const auto odims = ops->dimensions();
  if (tdims.size() != 3 || (int)tdims[2] != W + 1 || odims.size() != 2 ||
      odims[0] != tdims[1])
    return ffi::Error::InvalidArgument("tb (nw, P, W+1), ops (P, nb)");
  const int n_words = (int)tdims[0], P = (int)tdims[1], nb = (int)odims[1];
  constexpr int kThreads = 128;
  wave_trace_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      tb.typed_data(), geo.typed_data(), fin.typed_data(), P, W, n_words, nb,
      scores->typed_data(), ops->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(WaveFwd, WaveFwdImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("W"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(WaveTrace, WaveTraceImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("W"));
