// K2 standalone — the quantisation step of a batch of TUs as the coding
// passes run it (RDOQ or deadzone rounding, then sign hiding; see
// rdoq.cuh), one thread block per TU. The coding kernels inline the same
// device functions; this launch holds them alone against the plain
// version (ks265codec_tpu_torch/encode/rdoq.py::rdoq_sbh_plain).
//
// Bound: per coefficient two candidate costs (a handful of float32
// operations each) and about 10 integer operations, over 8 bytes in and
// out: bytes bound it at these sizes.
#include "rdoq.cuh"

namespace {

__global__ void rdoq_sbh_kernel(const int* coef, const int* qp,
                                const int* scan, const int* rank,
                                const int* tab, int* out, int n,
                                int flags) {
  __shared__ int c[KS_MAX_N * KS_MAX_N];
  __shared__ int lev[KS_MAX_N * KS_MAX_N];
  __shared__ float f[KS_MAX_N * KS_MAX_N];
  const int k = blockIdx.x;
  const int* ck = coef + (size_t)k * n * n;
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) c[p] = ck[p];
  __syncthreads();
  ks_levels_abs(tab, c, lev, f, n, qp[k], flags);
  __syncthreads();
  ks_group_pass(lev, c, f, n, flags, rank + 16 * scan[k]);
  __syncthreads();
  int* ok = out + (size_t)k * n * n;
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) ok[p] = lev[p];
}

}  // namespace

extern "C" int ks_rdoq_sbh(const void* coef, const void* qp,
                           const void* scan, const void* rank,
                           const void* tab, void* out, int K, int n,
                           int flags, void* stream) {
  if (K <= 0) return 0;
  if (n != 4 && n != 8 && n != 16 && n != 32)
    return (int)cudaErrorInvalidValue;
  rdoq_sbh_kernel<<<K, 256, 0, (cudaStream_t)stream>>>(
      (const int*)coef, (const int*)qp, (const int*)scan, (const int*)rank,
      (const int*)tab, (int*)out, n, flags);
  return (int)cudaGetLastError();
}
