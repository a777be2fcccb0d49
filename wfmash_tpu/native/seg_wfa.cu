// Segment WFA solver for NVIDIA Hopper (sm_90a), called from JAX through
// the XLA foreign function interface (align/wfa_seg.py).
//
// One thread block solves one problem; one thread owns one diagonal lane.
// The forward sweep runs score level by score level: each lane reads the
// five wavefront states of earlier levels (its own lane and its two
// neighbours), computes level s, extends its M cell by comparing the
// placed sequences in shared memory, and writes the level as int16 rows
// into the problem's history in device memory. One __syncthreads per level
// makes the row visible to the neighbour lanes and reduces the acceptance
// test. Thread 0 then walks the history back from the accepting cell
// (score-synchronous backtrace) and writes the RLE runs backwards.
//
// Semantics are those of wfa_np.wfa_align and of the plain-JAX twin in
// wfa_seg.py: same recurrences, same tie-breaks (X > I1 > I2 > D1 > D2,
// gap open before extend), same band-edge flag and acceptance rule, so
// CIGARs are bit-identical. Input row layout (per problem, L + 64 bytes):
// L/2 nibble-packed query codes | L/2 nibble-packed target codes | 16
// little-endian int32 parameters (see SegmentSolver._dispatch_chunk).
//
// Build (done at first use by align/wfa_seg.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o _seg_wfa_cuda.so \
//        seg_wfa.cu

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int NEG = -(1 << 28);
constexpr int16_t NEG16 = -2048;
constexpr int OP_EQ = 0, OP_X = 1, OP_I = 2, OP_D = 3, OP_SENTINEL = 15;
constexpr int M_ = 0, I1_ = 1, I2_ = 2, D1_ = 3, D2_ = 4;

struct Pen {
  int x, o1, e1, o2, e2;
};

struct Hist {
  int16_t* base;
  int smax;
  int K;

  __device__ __forceinline__ int get(int st, int s, int k) const {
    if (s < 0 || k < 0 || k >= K) return NEG;
    const int16_t v = base[(static_cast<size_t>(st) * smax + s) * K + k];
    return v == NEG16 ? NEG : static_cast<int>(v);
  }

  __device__ __forceinline__ void put(int st, int s, int k, int v) const {
    base[(static_cast<size_t>(st) * smax + s) * K + k] =
        v <= NEG / 2 ? NEG16 : static_cast<int16_t>(v);
  }
};

__global__ void __launch_bounds__(1024)
seg_wfa_kernel(const uint8_t* __restrict__ buf, int L, int smax, int maxr,
               Pen p, int32_t* __restrict__ runs_out,
               int32_t* __restrict__ term_out, int16_t* hist_all) {
  extern __shared__ uint8_t smem[];
  uint8_t* qs = smem;
  uint8_t* ts = smem + L;
  __shared__ int sh_lane[3];

  const int K = blockDim.x;
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  const uint8_t* row = buf + b * static_cast<size_t>(L + 64);
  for (int i = lane; i < L / 2; i += K) {
    const uint8_t vq = row[i];
    const uint8_t vt = row[L / 2 + i];
    qs[2 * i] = vq & 15;
    qs[2 * i + 1] = vq >> 4;
    ts[2 * i] = vt & 15;
    ts[2 * i + 1] = vt >> 4;
  }
  int par[9];
  for (int j = 0; j < 9; ++j) {
    const uint8_t* pp = row + L + 4 * j;
    par[j] = static_cast<int>(
        static_cast<uint32_t>(pp[0]) | (static_cast<uint32_t>(pp[1]) << 8) |
        (static_cast<uint32_t>(pp[2]) << 16) |
        (static_cast<uint32_t>(pp[3]) << 24));
  }
  // 0 Qk = S + qlen, 1 Tk = P + tlen, 2 S, 3 c = S - P, 4 tb, 5 qb,
  // 6 te, 7 qe (ends-free spans), 8 score cap (0 = none)
  const int Qk = par[0], Tk = par[1], S = par[2], c = par[3];
  const int tb = par[4], qb = par[5], te = par[6], qe = par[7];
  const int cap = par[8];

  int32_t* runs = runs_out + b * maxr;
  int32_t* term = term_out + b * 16;
  const Hist H{hist_all + b * 5 * static_cast<size_t>(smax) * K, smax, K};
  for (int i = lane; i < maxr; i += K) runs[i] = OP_SENTINEL << 13;
  if (lane < 3) sh_lane[lane] = K;
  __syncthreads();

  const int kvec = lane - K / 2;

  auto extend = [&](int h) -> int {
    if (h <= NEG) return h;
    int v = h - kvec;
    // pads (query 14, target 15) never match, so the run stops at the
    // end of either placed sequence
    while (h < L && v >= 0 && v < L && qs[h] == ts[v]) {
      ++h;
      ++v;
    }
    const int over = max(max(h - Qk, v - Tk), 0);
    return h - over;
  };
  auto accepting = [&](int m) -> bool {
    if (m <= NEG) return false;
    const int v = m - kvec;
    const bool c1 = (m == Qk) && (Tk - v <= te) && (v >= 0);
    const bool c2 = (v == Tk) && (Qk - m <= qe) && (m >= 0);
    return c1 || c2;
  };

  // ---- score 0: seeds (true diagonal = lane diagonal - c) -------------
  const int ktrue = kvec - c;
  int seed = NEG;
  if (ktrue <= 0 && -ktrue <= tb) seed = S;
  if (ktrue > 0 && ktrue <= qb) seed = S + ktrue;
  const int m0 = extend(seed);
  H.put(M_, 0, lane, m0);
  for (int g = I1_; g <= D2_; ++g) H.put(g, 0, lane, NEG);
  if (accepting(m0)) atomicMin(&sh_lane[0], lane);
  __syncthreads();
  int la = sh_lane[0];
  bool done = la < K;
  int s_final = 0, lane_a = done ? la : 0, edge = 0, swept = 1;

  // ---- forward sweep ---------------------------------------------------
  if (!done) {
    for (int s = 1; s < smax; ++s) {
      const int slot = s % 3;
      const int m_x = H.get(M_, s - p.x, lane);
      const int so1 = s - p.o1 - p.e1, so2 = s - p.o2 - p.e2;
      const int i1b = max(H.get(M_, so1, lane - 1),
                          H.get(I1_, s - p.e1, lane - 1));
      const int i2b = max(H.get(M_, so2, lane - 1),
                          H.get(I2_, s - p.e2, lane - 1));
      const int i1 = i1b > NEG ? i1b + 1 : NEG;
      const int i2 = i2b > NEG ? i2b + 1 : NEG;
      const int d1 = max(H.get(M_, so1, lane + 1),
                         H.get(D1_, s - p.e1, lane + 1));
      const int d2 = max(H.get(M_, so2, lane + 1),
                         H.get(D2_, s - p.e2, lane + 1));
      const int mm = m_x > NEG ? m_x + 1 : NEG;
      int moff = max(max(max(mm, i1), max(i2, d1)), d2);
      const int v = moff - kvec;
      if (!(moff >= 0 && moff <= Qk && v >= 0 && v <= Tk)) moff = NEG;
      const int mext = extend(moff);
      H.put(M_, s, lane, mext);
      H.put(I1_, s, lane, i1);
      H.put(I2_, s, lane, i2);
      H.put(D1_, s, lane, d1);
      H.put(D2_, s, lane, d2);
      if (accepting(mext)) atomicMin(&sh_lane[slot], lane);
      const bool eact = (lane == 0 || lane == K - 1) && mext > NEG;
      // barrier: level s is visible to every lane, the reductions are in
      edge |= __syncthreads_or(eact);
      la = sh_lane[slot];
      // the slot of level s - 1 is read by every lane before this barrier
      // and next used at level s + 2, after the next one
      if (lane == 0) sh_lane[(s + 2) % 3] = K;
      swept = s + 1;
      if (la < K) {
        done = true;
        s_final = s;
        lane_a = la;
        break;
      }
      if (cap > 0 && s >= cap) break;
    }
  }
  __syncthreads();
  if (lane != 0) return;

  // ---- backtrace (one thread) -----------------------------------------
  int cur = maxr - 1;
  auto emit = [&](int op, int n) {
    if (n <= 0) return;
    if (cur + 1 >= 0 && cur + 1 < maxr && (runs[cur + 1] >> 13) == op) {
      runs[cur + 1] += n;
      return;
    }
    if (cur >= 0) runs[cur] = (op << 13) | n;
    --cur;
  };
  const int h_a = done ? H.get(M_, s_final, lane_a) : 0;
  bool act = done, ok = true;
  int k = lane_a, h = h_a, st = M_, s = s_final;
  if (done) {
    // trailing free gap: the accepted cell may sit short of the corner
    const int v_acc = h - (k - K / 2);
    if (h == Qk && v_acc < Tk) {
      emit(OP_D, Tk - v_acc);
    } else if (v_acc == Tk && h < Qk) {
      emit(OP_I, Qk - h);
    }
  }
  while (act) {
    if (st == M_) {
      if (s == 0) {
        // extension run down to the seed, then the free begin gap
        const int kt_s = (k - K / 2) - c;
        emit(OP_EQ, h - S - max(kt_s, 0));
        if (kt_s < 0) emit(OP_D, -kt_s);
        if (kt_s > 0) emit(OP_I, kt_s);
        act = false;
        break;
      }
      int cx = H.get(M_, s - p.x, k);
      cx = cx > NEG ? cx + 1 : NEG;
      const int ci1 = H.get(I1_, s, k), ci2 = H.get(I2_, s, k);
      const int cd1 = H.get(D1_, s, k), cd2 = H.get(D2_, s, k);
      const int pre = max(max(max(cx, ci1), max(ci2, cd1)), cd2);
      if (pre <= NEG) {
        act = false;
        ok = false;
        break;
      }
      emit(OP_EQ, h - pre);
      if (cx == pre) {
        emit(OP_X, 1);
        s -= p.x;
        h = pre - 1;
        continue;
      }
      h = pre;
      st = ci1 == pre ? I1_ : ci2 == pre ? I2_ : cd1 == pre ? D1_ : D2_;
    }
    // gap state at level s: open (from M) before extend
    const bool ins = st == I1_ || st == I2_;
    const bool first = st == I1_ || st == D1_;
    const int o = first ? p.o1 : p.o2;
    const int e = first ? p.e1 : p.e2;
    const int kd = ins ? k - 1 : k + 1;
    const int open_ = H.get(M_, s - o - e, kd);
    const int ext = H.get(st, s - e, kd);
    emit(ins ? OP_I : OP_D, 1);
    const int want = ins ? h - 1 : h;
    if (open_ > NEG && open_ == want) {
      s -= o + e;
      h = want;
      k = kd;
      st = M_;
    } else if (ext > NEG && ext == want) {
      s -= e;
      h = want;
      k = kd;
    } else {
      act = false;
      ok = false;
    }
  }
  for (int j = 0; j < 16; ++j) term[j] = 0;
  term[0] = done ? 1 : 0;
  term[1] = s_final;
  term[2] = done ? 0 : 1;
  term[3] = edge ? 1 : 0;
  term[4] = cur;
  term[5] = (ok && !act) ? 1 : 0;
  term[6] = done ? lane_a : 0;
  term[7] = h_a;
  term[8] = swept;
}

ffi::Error SegWfaImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> buf,
                      ffi::ResultBuffer<ffi::S32> runs,
                      ffi::ResultBuffer<ffi::S32> term,
                      ffi::ResultBuffer<ffi::S16> hist, int32_t K,
                      int32_t smax, int32_t maxr, int32_t x, int32_t o1,
                      int32_t e1, int32_t o2, int32_t e2) {
  const auto dims = buf.dimensions();
  if (dims.size() != 2) {
    return ffi::Error::InvalidArgument("seg_wfa: input must be 2-D");
  }
  if (K < 32 || K > 1024 || K % 32 != 0) {
    return ffi::Error::InvalidArgument("seg_wfa: K must be 32..1024, %32");
  }
  const int64_t B = dims[0];
  const int L = static_cast<int>(dims[1] - 64);
  if (B == 0) return ffi::Error::Success();
  seg_wfa_kernel<<<static_cast<unsigned>(B), K, 2 * static_cast<size_t>(L),
                   stream>>>(buf.typed_data(), L, smax, maxr,
                             Pen{x, o1, e1, o2, e2}, runs->typed_data(),
                             term->typed_data(), hist->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("seg_wfa launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SegWfa, SegWfaImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S16>>()
                                  .Attr<int32_t>("K")
                                  .Attr<int32_t>("smax")
                                  .Attr<int32_t>("maxr")
                                  .Attr<int32_t>("x")
                                  .Attr<int32_t>("o1")
                                  .Attr<int32_t>("e1")
                                  .Attr<int32_t>("o2")
                                  .Attr<int32_t>("e2"));
