// T-step tile passes for turbo's dense 8-neighbour fixpoints.
//
// One launch advances a fixpoint by T Jacobi steps. Each block loads a tile
// of the read-only plane and the 1-3 read-write planes plus a T-cell halo
// into shared memory, applies T steps of its rule there (double-buffered,
// one __syncthreads() per step), writes the interior back and ORs a
// "changed" flag into one int32 output. A step of every rule reads only the
// 8 neighbours, so after T steps the interior equals T steps of the global
// sweep exactly: the XLA sweeps in models/turbo.py are the specification,
// and every rule below transcribes one sweep body, direction order and
// out-of-image fills included.
//
// Build: make -C gseg/native tilepass   (needs nvcc; sm_90a)

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kIntMax = 0x7fffffff;
constexpr int32_t kBigDist = 1 << 30;
constexpr uint32_t kInfBits = 0x7f800000u;  // +inf as float32 bits

// grid_graph.DIRS8: E S SE NE, then W N NW SW.
__device__ __forceinline__ constexpr int Dy(int d) {
  return d == 0 ? 0 : d <= 3 ? 1 : d == 4 ? 0 : -1;
}
__device__ __forceinline__ constexpr int Dx(int d) {
  return d == 0 ? 1 : d == 1 ? 0 : d == 2 ? 1 : d == 3 ? -1
       : d == 4 ? -1 : d == 5 ? 0 : d == 6 ? -1 : 1;
}

__device__ __forceinline__ float F(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ uint32_t B(float f) { return __float_as_uint(f); }

// Each rule: kRW read-write planes, the out-of-image fill of every plane
// (bit patterns), and Step(): one sweep body at cell i of a tile whose rows
// are `sw` words apart, reading `cur` and writing `nxt`.

// turbo._compmin_gossip: lexmin (bw, be) + max sz among same-L neighbours.
struct Compmin {
  static constexpr int kRW = 3;
  static constexpr uint32_t kRoFill = 0xffffffffu;  // L: -1
  __device__ static uint32_t Fill(int k) {
    return k == 0 ? kInfBits : k == 1 ? uint32_t(kIntMax) : 0u;
  }
  __device__ static void Step(const uint32_t* ro, uint32_t* const* cur,
                              uint32_t* const* nxt, int i, int sw) {
    const int32_t L = int32_t(ro[i]);
    float bw = F(cur[0][i]);
    int32_t be = int32_t(cur[1][i]);
    int32_t sz = int32_t(cur[2][i]);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int j = i + Dy(d) * sw + Dx(d);
      const bool same = int32_t(ro[j]) == L;
      const float nbw = F(cur[0][j]);
      const int32_t nbe = int32_t(cur[1][j]);
      const int32_t nsz = int32_t(cur[2][j]);
      const bool take = same && (nbw < bw || (nbw == bw && nbe < be));
      if (take) {
        bw = nbw;
        be = nbe;
      }
      if (same && nsz > sz) sz = nsz;
    }
    nxt[0][i] = B(bw);
    nxt[1][i] = uint32_t(be);
    nxt[2][i] = uint32_t(sz);
  }
};

// turbo._label_gossip: min-label flood over allowed edges with Int max and
// the BFS dist riding along. ro = packed allow bits (bit d: DIRS8[d]).
struct LabelDist {
  static constexpr int kRW = 3;
  static constexpr uint32_t kRoFill = 0u;
  __device__ static uint32_t Fill(int k) {
    return k == 0 ? uint32_t(kIntMax) : k == 1 ? 0u : uint32_t(kBigDist);
  }
  __device__ static void Step(const uint32_t* ro, uint32_t* const* cur,
                              uint32_t* const* nxt, int i, int sw) {
    const uint32_t allow = ro[i];
    int32_t lc = int32_t(cur[0][i]);
    float idf = F(cur[1][i]);
    int32_t dist = int32_t(cur[2][i]);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int j = i + Dy(d) * sw + Dx(d);
      const bool a = (allow >> d) & 1u;
      const int32_t nl = int32_t(cur[0][j]);
      const float nid = F(cur[1][j]);
      const int32_t nds = int32_t(cur[2][j]);
      const int32_t cand = nds >= kBigDist ? kBigDist : nds + 1;
      const bool adopt = a && nl < lc;
      const bool relax = a && nl == lc && cand < dist;
      if (adopt || relax) dist = cand;
      if (adopt) lc = nl;
      if (a && nid > idf) idf = nid;
    }
    nxt[0][i] = uint32_t(lc);
    nxt[1][i] = B(idf);
    nxt[2][i] = uint32_t(dist);
  }
};

// turbo._label_gossip_nd: the dist-free flood.
struct Label {
  static constexpr int kRW = 2;
  static constexpr uint32_t kRoFill = 0u;
  __device__ static uint32_t Fill(int k) {
    return k == 0 ? uint32_t(kIntMax) : 0u;
  }
  __device__ static void Step(const uint32_t* ro, uint32_t* const* cur,
                              uint32_t* const* nxt, int i, int sw) {
    const uint32_t allow = ro[i];
    int32_t lc = int32_t(cur[0][i]);
    float idf = F(cur[1][i]);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int j = i + Dy(d) * sw + Dx(d);
      const bool a = (allow >> d) & 1u;
      const int32_t nl = int32_t(cur[0][j]);
      const float nid = F(cur[1][j]);
      if (a && nl < lc) lc = nl;
      if (a && nid > idf) idf = nid;
    }
    nxt[0][i] = uint32_t(lc);
    nxt[1][i] = B(idf);
  }
};

// turbo._value_flood: min-value broadcast within same-L regions.
struct Value {
  static constexpr int kRW = 1;
  static constexpr uint32_t kRoFill = 0xffffffffu;  // L: -1
  __device__ static uint32_t Fill(int) { return uint32_t(kIntMax); }
  __device__ static void Step(const uint32_t* ro, uint32_t* const* cur,
                              uint32_t* const* nxt, int i, int sw) {
    const int32_t L = int32_t(ro[i]);
    int32_t val = int32_t(cur[0][i]);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int j = i + Dy(d) * sw + Dx(d);
      const int32_t nv = int32_t(cur[0][j]);
      if (int32_t(ro[j]) == L && nv < val) val = nv;
    }
    nxt[0][i] = uint32_t(val);
  }
};

// turbo._subtree_sizes: s <- 1 + sum of the children's s. ro = parent
// direction (8 = none); a neighbour in direction d is a child when its
// parent direction is the reverse of d.
struct Subsum {
  static constexpr int kRW = 1;
  static constexpr uint32_t kRoFill = 8u;
  __device__ static uint32_t Fill(int) { return 0u; }
  __device__ static void Step(const uint32_t* ro, uint32_t* const* cur,
                              uint32_t* const* nxt, int i, int sw) {
    int32_t total = 1;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int j = i + Dy(d) * sw + Dx(d);
      if (int32_t(ro[j]) == ((d + 4) & 7)) total += int32_t(cur[0][j]);
    }
    nxt[0][i] = uint32_t(total);
  }
};

struct Planes {
  const uint32_t* in[3];
  uint32_t* out[3];
};

template <class R>
__global__ void TilePass(int h, int w, int t, int th, int tw,
                         const uint32_t* __restrict__ ro, Planes p,
                         int32_t* __restrict__ flag) {
  extern __shared__ uint32_t smem[];
  const int sh = th + 2 * t, sw = tw + 2 * t, n = sh * sw;
  const int y0 = int(blockIdx.y) * th - t, x0 = int(blockIdx.x) * tw - t;
  uint32_t* sro = smem;
  uint32_t* cur[R::kRW];
  uint32_t* nxt[R::kRW];
#pragma unroll
  for (int k = 0; k < R::kRW; ++k) {
    cur[k] = smem + n * (1 + k);
    nxt[k] = smem + n * (1 + R::kRW + k);
  }

  for (int r = threadIdx.y; r < sh; r += blockDim.y) {
    const int gy = y0 + r;
    for (int c = threadIdx.x; c < sw; c += blockDim.x) {
      const int gx = x0 + c;
      const int i = r * sw + c;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const size_t g = size_t(gy) * w + gx;
        sro[i] = ro[g];
#pragma unroll
        for (int k = 0; k < R::kRW; ++k) cur[k][i] = p.in[k][g];
      } else {
        sro[i] = R::kRoFill;
#pragma unroll
        for (int k = 0; k < R::kRW; ++k) cur[k][i] = R::Fill(k);
      }
    }
  }
  __syncthreads();

  // Step s recomputes the cells at least s + 1 from the tile edge: all the
  // remaining steps need, and the interior after the last one.
  for (int s = 0; s < t; ++s) {
    const int lo = s + 1;
    for (int r = lo + threadIdx.y; r < sh - lo; r += blockDim.y) {
      const int gy = y0 + r;
      for (int c = lo + threadIdx.x; c < sw - lo; c += blockDim.x) {
        const int gx = x0 + c;
        const int i = r * sw + c;
        if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
          R::Step(sro, cur, nxt, i, sw);
        } else {
#pragma unroll
          for (int k = 0; k < R::kRW; ++k) nxt[k][i] = R::Fill(k);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < R::kRW; ++k) {
      uint32_t* tmp = cur[k];
      cur[k] = nxt[k];
      nxt[k] = tmp;
    }
  }

  int changed = 0;
  for (int r = t + threadIdx.y; r < t + th; r += blockDim.y) {
    const int gy = y0 + r;
    if (gy >= h) break;
    for (int c = t + threadIdx.x; c < t + tw; c += blockDim.x) {
      const int gx = x0 + c;
      if (gx >= w) break;
      const size_t g = size_t(gy) * w + gx;
      const int i = r * sw + c;
#pragma unroll
      for (int k = 0; k < R::kRW; ++k) {
        const uint32_t v = cur[k][i];
        changed |= v != p.in[k][g];
        p.out[k][g] = v;
      }
    }
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0 && threadIdx.y == 0) {
    atomicOr(flag, 1);
  }
}

constexpr int kBlockX = 32, kBlockY = 16;

template <class R>
ffi::Error Launch(cudaStream_t stream, const ffi::AnyBuffer& ro,
                  const ffi::AnyBuffer* in, ffi::Result<ffi::AnyBuffer>* out,
                  ffi::Result<ffi::AnyBuffer>& flag, int32_t t, int32_t th,
                  int32_t tw) {
  const auto dims = ro.dimensions();
  if (dims.size() != 2) {
    return ffi::Error::InvalidArgument("tile pass: planes must be 2-D");
  }
  const int h = int(dims[0]), w = int(dims[1]);
  if (t < 1 || th < 1 || tw < 1) {
    return ffi::Error::InvalidArgument("tile pass: bad tile geometry");
  }
  Planes p{};
  for (int k = 0; k < R::kRW; ++k) {
    if (in[k].element_count() != size_t(h) * w) {
      return ffi::Error::InvalidArgument("tile pass: plane shape mismatch");
    }
    p.in[k] = static_cast<const uint32_t*>(in[k].untyped_data());
    p.out[k] = static_cast<uint32_t*>(out[k]->untyped_data());
  }
  auto* f = static_cast<int32_t*>(flag->untyped_data());
  cudaMemsetAsync(f, 0, sizeof(int32_t), stream);
  const size_t smem =
      size_t(1 + 2 * R::kRW) * (th + 2 * t) * (tw + 2 * t) * sizeof(uint32_t);
  cudaFuncSetAttribute(TilePass<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       int(smem));
  const dim3 grid((w + tw - 1) / tw, (h + th - 1) / th);
  const dim3 block(kBlockX, kBlockY);
  TilePass<R><<<grid, block, smem, stream>>>(
      h, w, t, th, tw, static_cast<const uint32_t*>(ro.untyped_data()), p, f);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

template <class R>
ffi::Error Run1(cudaStream_t s, ffi::AnyBuffer ro, ffi::AnyBuffer a,
                ffi::Result<ffi::AnyBuffer> flag,
                ffi::Result<ffi::AnyBuffer> oa, int32_t t, int32_t th,
                int32_t tw) {
  ffi::AnyBuffer in[1] = {a};
  ffi::Result<ffi::AnyBuffer> out[1] = {oa};
  return Launch<R>(s, ro, in, out, flag, t, th, tw);
}

template <class R>
ffi::Error Run2(cudaStream_t s, ffi::AnyBuffer ro, ffi::AnyBuffer a,
                ffi::AnyBuffer b, ffi::Result<ffi::AnyBuffer> flag,
                ffi::Result<ffi::AnyBuffer> oa,
                ffi::Result<ffi::AnyBuffer> ob, int32_t t, int32_t th,
                int32_t tw) {
  ffi::AnyBuffer in[2] = {a, b};
  ffi::Result<ffi::AnyBuffer> out[2] = {oa, ob};
  return Launch<R>(s, ro, in, out, flag, t, th, tw);
}

template <class R>
ffi::Error Run3(cudaStream_t s, ffi::AnyBuffer ro, ffi::AnyBuffer a,
                ffi::AnyBuffer b, ffi::AnyBuffer c,
                ffi::Result<ffi::AnyBuffer> flag,
                ffi::Result<ffi::AnyBuffer> oa,
                ffi::Result<ffi::AnyBuffer> ob,
                ffi::Result<ffi::AnyBuffer> oc, int32_t t, int32_t th,
                int32_t tw) {
  ffi::AnyBuffer in[3] = {a, b, c};
  ffi::Result<ffi::AnyBuffer> out[3] = {oa, ob, oc};
  return Launch<R>(s, ro, in, out, flag, t, th, tw);
}

}  // namespace

// Arguments: the read-only plane, then the read-write planes. Results: the
// changed flag, then the updated read-write planes.
#define GSEG_ATTRS                 \
  .Attr<int32_t>("steps")          \
      .Attr<int32_t>("tile_h")     \
      .Attr<int32_t>("tile_w")

#define GSEG_BIND3                                      \
  ffi::Ffi::Bind()                                      \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()         \
      .Arg<ffi::AnyBuffer>()                            \
      .Arg<ffi::AnyBuffer>()                            \
      .Arg<ffi::AnyBuffer>()                            \
      .Arg<ffi::AnyBuffer>()                            \
      .Ret<ffi::AnyBuffer>()                            \
      .Ret<ffi::AnyBuffer>()                            \
      .Ret<ffi::AnyBuffer>()                            \
      .Ret<ffi::AnyBuffer>() GSEG_ATTRS

#define GSEG_BIND2                                      \
  ffi::Ffi::Bind()                                      \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()         \
      .Arg<ffi::AnyBuffer>()                            \
      .Arg<ffi::AnyBuffer>()                            \
      .Arg<ffi::AnyBuffer>()                            \
      .Ret<ffi::AnyBuffer>()                            \
      .Ret<ffi::AnyBuffer>()                            \
      .Ret<ffi::AnyBuffer>() GSEG_ATTRS

#define GSEG_BIND1                                      \
  ffi::Ffi::Bind()                                      \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()         \
      .Arg<ffi::AnyBuffer>()                            \
      .Arg<ffi::AnyBuffer>()                            \
      .Ret<ffi::AnyBuffer>()                            \
      .Ret<ffi::AnyBuffer>() GSEG_ATTRS

XLA_FFI_DEFINE_HANDLER_SYMBOL(GsegTilePassCompmin, Run3<Compmin>, GSEG_BIND3);
XLA_FFI_DEFINE_HANDLER_SYMBOL(GsegTilePassLabelDist, Run3<LabelDist>,
                              GSEG_BIND3);
XLA_FFI_DEFINE_HANDLER_SYMBOL(GsegTilePassLabel, Run2<Label>, GSEG_BIND2);
XLA_FFI_DEFINE_HANDLER_SYMBOL(GsegTilePassValue, Run1<Value>, GSEG_BIND1);
XLA_FFI_DEFINE_HANDLER_SYMBOL(GsegTilePassSubsum, Run1<Subsum>, GSEG_BIND1);
