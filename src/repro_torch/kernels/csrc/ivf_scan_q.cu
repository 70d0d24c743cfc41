// IVF probed-cluster scan over int8 tiles with fused dequantization (see
// cluster_scan.cuh for the design).
//
// Replaces the TPU kernel src/repro/kernels/ivf_scan_q.py::cluster_scan_q
// (body _scan_kernel_q): the cluster_scan grid over symmetric per-vector int8
// tiles; the tile is upcast for the dot and the score multiplied by the
// vector's f32 scale afterwards (the scale factors out of the dot product).
//
// What bounds it on an H100: a scanned vector costs d + 4 bytes of tile and
// scale plus 4 of mask, nb*slots*L*(d + 8) bytes in all, for 2*BQ*d FLOP:
// about 16 FLOP/B at BQ=8 and d=384, close to the fp32 ridge point (20
// FLOP/B), so bytes and fp32 issue both matter.  The int8 tile is streamed
// as it is stored, 4 bytes per lane per load (char4), upcast in registers;
// no dequantized copy of the tile exists anywhere in device memory, so the
// d + 4 bytes-per-vector accounting (index/quant.py) describes this kernel.
// The query stays fp32: it is not quantized.  Each score is scaled once,
// after its dot product, as the reference does.
#include "cluster_scan.cuh"

extern "C" {

// queries [nb*bq, d] f32, store_q [kc, L, d] int8, scales [kc, L] f32,
// mask [kc, L] f32, probe_blocks [nb, slots] int32, out [nb*bq, slots*L] f32;
// all contiguous on `device`, launched on `stream`.  Returns the CUDA error
// code (0 = ok).
int repro_cluster_scan_q(const void* queries, const void* store_q, const void* scales,
                         const void* mask, const void* probe_blocks, void* out,
                         long long nb, int bq, long long kc, long long L, long long d,
                         long long slots, int normalize, int device, void* stream) {
  return repro_scan::launch<int8_t, true>(queries, store_q, scales, mask, probe_blocks,
                                          out, nb, bq, kc, L, d, slots, normalize,
                                          device, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
