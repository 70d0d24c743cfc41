// IVF probed-cluster scan over fp32 tiles (see cluster_scan.cuh for the design).
//
// Replaces the TPU kernel src/repro/kernels/ivf_scan.py::cluster_scan (body
// _scan_kernel): grid (query block, probe slot), the probed cluster's tile
// gathered by a scalar-prefetched BlockSpec index map, an MXU dot of the
// 8-row query block against the [L, d] tile, padding lanes set to -1e30.
//
// What bounds it on an H100: memory.  Every probed tile is read once per
// (block, slot): nb*slots*L*(4d + 4) bytes in (store row + mask), 4*BQ bytes
// out per row, against 2*BQ*d FLOP per row: about 4 FLOP/B at BQ=8, far
// below the fp32 ridge point (67 TFLOP/s / 3.35 TB/s = 20 FLOP/B).  So the
// design spends its effort on the byte stream: 16-byte coalesced loads of
// the tile, every tile byte read exactly once per CTA, the queries held in
// shared memory instead of re-read, and a transposing warp reduction so the
// few FLOPs per byte never become the limit.  Repeated tiles across blocks
// are left to the 50 MB L2; a later kernel could schedule them to share.
#include "cluster_scan.cuh"

extern "C" {

// queries [nb*bq, d] f32, store [kc, L, d] f32, mask [kc, L] f32,
// probe_blocks [nb, slots] int32, out [nb*bq, slots*L] f32; all contiguous
// on `device`, launched on `stream`.  Returns the CUDA error code (0 = ok).
int repro_cluster_scan(const void* queries, const void* store, const void* mask,
                       const void* probe_blocks, void* out, long long nb, int bq,
                       long long kc, long long L, long long d, long long slots,
                       int normalize, int device, void* stream) {
  return repro_scan::launch<float, false>(queries, store, nullptr, mask, probe_blocks,
                                          out, nb, bq, kc, L, d, slots, normalize,
                                          device, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
