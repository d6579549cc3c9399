// Broker aggregates: one pass over every (partition, replica slot) of the
// cluster model, producing the per-broker loads and counts of the goal stack.
//
// Replaces the TPU kernel `_kernel` / `broker_aggregates_mxu` in
// ccx/ops/mxu_aggregates.py (the pl.pallas_call there). The TPU version
// turns every sum into a one-hot matrix product for the MXU; that has no
// reason to exist on Hopper, so this kernel reads the model's own arrays
// (assignment, leader_slot, replica_disk, partition_valid, partition_topic,
// leader_load, follower_load) and scatters each replica into its broker.
//
// What bounds it on an H100: bytes. At B5 (P=131072 padded, 100k live,
// R=3, B=1024, T=512) it reads ~6.5 MB of model arrays (a padding partition
// costs only its valid byte) and writes ~4.2 MB of outputs, almost all of
// it the two int32[T, B] topic matrices — about 3 microseconds at 3.35 TB/s.
// The arithmetic is at most 12 additions per replica. In practice atomic
// contention on the hot brokers (a fixture's skew piles replicas onto a
// quarter of the brokers) sets the time.
//
// Design: a grid-stride loop over partitions, one thread per partition
// handling its R slots. While the eight per-broker rows (4 loads, potential
// NW_OUT, leader bytes-in, replica count, leader count; 8 * B * 4 bytes) fit
// in shared memory (B <= 2048) each block accumulates them privately with
// shared-memory atomics and flushes the nonzero cells to the output with one
// global atomic each; above that the same loop adds to the outputs directly.
// The [T, B] and [B, D] outputs always take global atomics — their cells are
// spread thin, so contention there is low. Counts use int32 atomics and are
// exact; float sums land in a run-dependent order.
//
// Interface: plain C, loaded with ctypes. The caller allocates and zeroes
// every output, launches on its stream, and checks the returned
// cudaGetLastError() code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRes = 4;      // CPU, NW_IN, NW_OUT, DISK
constexpr int kNwIn = 1;
constexpr int kNwOut = 2;
constexpr int kDisk = 3;
constexpr int kRows = 8;     // per-broker rows kept in shared memory
constexpr int kMaxSharedBrokers = 2048;
constexpr int kThreads = 512;

template <bool kShared>
__global__ void broker_aggregates_kernel(
    const int32_t* __restrict__ assignment,      // [P, R]
    const int32_t* __restrict__ leader_slot,     // [P]
    const int32_t* __restrict__ replica_disk,    // [P, R]
    const uint8_t* __restrict__ partition_valid, // [P]
    const int32_t* __restrict__ partition_topic, // [P]
    const float* __restrict__ leader_load,       // [RES, P]
    const float* __restrict__ follower_load,     // [RES, P]
    int P, int R, int B, int T, int D,
    float* broker_load,                          // [RES, B]
    int32_t* replica_count,                      // [B]
    int32_t* leader_count,                       // [B]
    float* potential_nw_out,                     // [B]
    float* leader_bytes_in,                      // [B]
    int32_t* topic_replica_count,                // [T, B]
    int32_t* topic_leader_count,                 // [T, B]
    float* disk_load) {                          // [B, D]
  extern __shared__ float smem[];
  float* load_acc = broker_load;
  float* pot_acc = potential_nw_out;
  float* lbi_acc = leader_bytes_in;
  int32_t* rc_acc = replica_count;
  int32_t* lc_acc = leader_count;
  if (kShared) {
    load_acc = smem;
    pot_acc = smem + kRes * B;
    lbi_acc = smem + (kRes + 1) * B;
    rc_acc = reinterpret_cast<int32_t*>(smem + (kRes + 2) * B);
    lc_acc = reinterpret_cast<int32_t*>(smem + (kRes + 3) * B);
    for (int i = threadIdx.x; i < kRows * B; i += blockDim.x) smem[i] = 0.0f;
    __syncthreads();
  }

  const int stride = gridDim.x * blockDim.x;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P; p += stride) {
    if (!partition_valid[p]) continue;
    const int lead = leader_slot[p];
    const int t = partition_topic[p];
    float ll[kRes], fl[kRes];
#pragma unroll
    for (int r = 0; r < kRes; ++r) {
      ll[r] = leader_load[(size_t)r * P + p];
      fl[r] = follower_load[(size_t)r * P + p];
    }
    for (int s = 0; s < R; ++s) {
      const int b = assignment[(size_t)p * R + s];
      if (b < 0 || b >= B) continue;
      const bool is_lead = (s == lead);
#pragma unroll
      for (int r = 0; r < kRes; ++r)
        atomicAdd(&load_acc[r * B + b], is_lead ? ll[r] : fl[r]);
      atomicAdd(&pot_acc[b], ll[kNwOut]);
      atomicAdd(&rc_acc[b], 1);
      if (is_lead) {
        atomicAdd(&lc_acc[b], 1);
        atomicAdd(&lbi_acc[b], ll[kNwIn]);
      }
      if (t >= 0 && t < T) {
        atomicAdd(&topic_replica_count[(size_t)t * B + b], 1);
        if (is_lead) atomicAdd(&topic_leader_count[(size_t)t * B + b], 1);
      }
      const int d = replica_disk[(size_t)p * R + s];
      if (d >= 0 && d < D)
        atomicAdd(&disk_load[(size_t)b * D + d], is_lead ? ll[kDisk] : fl[kDisk]);
    }
  }

  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
#pragma unroll
      for (int r = 0; r < kRes; ++r) {
        const float v = load_acc[r * B + b];
        if (v != 0.0f) atomicAdd(&broker_load[r * B + b], v);
      }
      if (pot_acc[b] != 0.0f) atomicAdd(&potential_nw_out[b], pot_acc[b]);
      if (lbi_acc[b] != 0.0f) atomicAdd(&leader_bytes_in[b], lbi_acc[b]);
      if (rc_acc[b] != 0) atomicAdd(&replica_count[b], rc_acc[b]);
      if (lc_acc[b] != 0) atomicAdd(&leader_count[b], lc_acc[b]);
    }
  }
}

}  // namespace

extern "C" int ccx_broker_aggregates(
    const void* assignment, const void* leader_slot, const void* replica_disk,
    const void* partition_valid, const void* partition_topic,
    const void* leader_load, const void* follower_load,
    int P, int R, int B, int T, int D,
    void* broker_load, void* replica_count, void* leader_count,
    void* potential_nw_out, void* leader_bytes_in,
    void* topic_replica_count, void* topic_leader_count, void* disk_load,
    void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int blocks = (P + kThreads - 1) / kThreads;
  if (blocks > sms) blocks = sms;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int32_t* a = static_cast<const int32_t*>(assignment);
  const int32_t* ls = static_cast<const int32_t*>(leader_slot);
  const int32_t* rd = static_cast<const int32_t*>(replica_disk);
  const uint8_t* pv = static_cast<const uint8_t*>(partition_valid);
  const int32_t* pt = static_cast<const int32_t*>(partition_topic);
  const float* lload = static_cast<const float*>(leader_load);
  const float* fload = static_cast<const float*>(follower_load);
  float* bl = static_cast<float*>(broker_load);
  int32_t* rc = static_cast<int32_t*>(replica_count);
  int32_t* lc = static_cast<int32_t*>(leader_count);
  float* pot = static_cast<float*>(potential_nw_out);
  float* lbi = static_cast<float*>(leader_bytes_in);
  int32_t* trc = static_cast<int32_t*>(topic_replica_count);
  int32_t* tlc = static_cast<int32_t*>(topic_leader_count);
  float* dl = static_cast<float*>(disk_load);

  if (B <= kMaxSharedBrokers) {
    const size_t smem = (size_t)kRows * B * sizeof(float);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(broker_aggregates_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    broker_aggregates_kernel<true><<<blocks, kThreads, smem, s>>>(
        a, ls, rd, pv, pt, lload, fload, P, R, B, T, D,
        bl, rc, lc, pot, lbi, trc, tlc, dl);
  } else {
    broker_aggregates_kernel<false><<<blocks, kThreads, 0, s>>>(
        a, ls, rd, pv, pt, lload, fload, P, R, B, T, D,
        bl, rc, lc, pot, lbi, trc, tlc, dl);
  }
  return (int)cudaGetLastError();
}
