// Broker aggregates: one pass over every live partition of the cluster
// model, producing the per-broker loads and counts of the goal stack.
//
// Replaces the TPU kernel `_kernel` (ccx/ops/mxu_aggregates.py:95), launched
// by `broker_aggregates_mxu` through the pl.pallas_call at :210. The TPU
// version turns every sum into a one-hot matrix product for the MXU and
// carries [T, B] accumulators in VMEM across a sequential grid. Neither
// carries over: Hopper's blocks run in parallel and share no accumulators.
//
// What bounds it on an H100: bytes. At B5 (P=131072 padded, 100k live,
// R=3, B=1024, T=512, D=1) the function reads ~6.5 MB of model arrays and
// writes ~4.2 MB, almost all of it the two int32 [T, B] topic matrices:
// 3.2 microseconds at 3.35 TB/s. The arithmetic is at most 12 additions per
// replica. The first design, a grid-stride scatter with global atomics into
// eight zero-filled outputs, took 40.5 us on the card at B5, plus 8.2 us of
// fills; its 0.106 ms "kernel time" was mostly the host enqueueing the
// call. Its global atomics went to the 4 MB topic matrices (~350k, spread
// thin) and the 1024 disk cells (~250k, contended), and each of its 132
// blocks flushed 8 x 1024 cells at the end.
//
// The design, part by part:
// - Topic-owned topic rows. The caller passes the live partitions grouped
//   by topic (`order`, with `offsets[T+1]`; live partitions whose topic is
//   out of range follow offsets[T]). Block g of a broker tile owns the
//   topics whose first entry falls in its 1/G share of the index, counts
//   their replicas and leaders per broker in shared memory and writes each
//   row out whole, zeros included, with 16-byte stores. The topic matrices
//   take no atomics and no fill.
// - The eight per-broker rows (4 loads, replica count, leader count,
//   potential NW_OUT, leader bytes-in) and the [B, D] disk rows, which the
//   caller zeroes (36 KB at B5) with one memset, are summed one of two
//   ways, chosen per call from the input (`plan`):
//   - shared rows, for dense clusters: each block adds its replicas into
//     its own rows in shared memory; a cluster of 4 blocks sums them
//     through distributed shared memory, each block a quarter of the cells,
//     and adds them to the output with one global atomic per non-zero cell:
//     4x fewer than one flush per block;
//   - global rows, for sparse ones: each replica adds straight into the
//     output. Zeroing and reducing a block's 9 x B cells costs more than
//     the atomics they save once a block adds fewer replica slots than it
//     holds brokers (the 4000-broker fixture: ~67 partitions per block
//     against 4096 brokers).
// - Broker tiles. Where a block's words per broker (two topic rows, and
//   the nine shared rows) do not fit in its shared memory for all B
//   brokers (B6, 16384 brokers, with shared rows), the broker axis is cut
//   into tiles along gridDim.y; each tile's blocks read every live
//   partition and keep the replicas on their tile's brokers.
// - Launch shape. 1024 threads, one block per SM, each thread reading all
//   of a partition's slots and loads before its additions; the grid is as
//   many clusters as fit at once (30 clusters of 4 on an H100), shared
//   among the broker tiles. The device attributes and the shared-memory
//   limit are set once per device (`ccx_broker_aggregates_init`).
//
// Where the time goes with shared rows (B5, H100, per-phase stamps of the
// blocks): ~15 us, of which ~7 us is the pass over the entries, ~1 us each
// finding the owned topics, writing the topic rows, waiting at and
// reducing across the cluster. Shared memory has no float atomic add:
// atomicAdd on a shared float compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN), six or seven per replica. Packing the floats into 8-
// or 16-byte compare-and-swap loops, and a counting sort of each pass's
// replicas by broker with plain adds by the broker's owning thread, were no
// faster at B5.
//
// Counts use int32 atomics and are exact; float sums land in a
// run-dependent order.
//
// Interface: plain C, loaded with ctypes. The caller allocates the one
// output buffer, launches on its stream, and checks the returned
// cudaGetLastError() code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRes = 4;      // CPU, NW_IN, NW_OUT, DISK
constexpr int kNwIn = 1;
constexpr int kNwOut = 2;
constexpr int kDisk = 3;
// the eight per-broker rows, in shared memory and in the output: kRes loads
// (rows 0-3), then
constexpr int kRc = 4;       // replica count (int32)
constexpr int kLc = 5;       // leader count (int32)
constexpr int kPot = 6;      // potential NW_OUT
constexpr int kLbi = 7;      // leader bytes-in
constexpr int kRows = 8;
constexpr int kThreads = 1024;
constexpr int kBlocksPerSm = 1;
constexpr int kCluster = 4;
constexpr int kMaxDevices = 64;
constexpr int kMaxR = 4;     // replica slots read ahead into registers

// one live partition, read ahead of its additions
struct Entry {
  int p, lead, row;
  float ll[kRes], fl[kRes];
  int b[kMaxR], d[kMaxR];
};

// kSharedRows: the per-broker and disk rows are summed in each block's
// shared memory and reduced across its cluster; otherwise every replica
// adds into the output.
template <bool kSharedRows>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) broker_aggregates_kernel(
    const int32_t* __restrict__ order,           // [n_live] live partitions by topic
    const int32_t* __restrict__ offsets,         // [T + 1]
    int n_live,
    const int32_t* __restrict__ assignment,      // [P, R]
    const int32_t* __restrict__ leader_slot,     // [P]
    const int32_t* __restrict__ replica_disk,    // [P, R]
    const int32_t* __restrict__ partition_topic, // [P]
    const float* __restrict__ leader_load,       // [RES, P]
    const float* __restrict__ follower_load,     // [RES, P]
    int P, int R, int B, int T, int D, int BT, int KT,
    int32_t* __restrict__ topic_counts,          // [2, T, B]: replicas, leaders
    float* __restrict__ rows) {                  // [8, B] then [B, D], zeroed
  // shared words: with kSharedRows the per-broker rows [8][BT] and the disk
  // rows [BT][D]; then the topic rows [KT][2][BT]
  extern __shared__ __align__(16) float smem[];
  const int n_row_words = kSharedRows ? (kRows + D) * BT : 0;
  int32_t* s_topic = reinterpret_cast<int32_t*>(smem + n_row_words);
  __shared__ int s_t0, s_t1, s_e0, s_e1;

  const int G = gridDim.x, g = blockIdx.x;
  const int b_lo = blockIdx.y * BT;
  const int bt = min(BT, B - b_lo);
  const int tid = threadIdx.x, nt = blockDim.x;
  // where a replica's per-broker sums go: row k of broker cell `at` is
  // row_base[k * stride + at], and its disk d row_base[kRows * stride +
  // at * D + d]
  float* const row_base = kSharedRows ? smem : rows;
  const int stride = kSharedRows ? BT : B;

  // Topic t belongs to the group whose share of the index holds its first
  // entry; -1 and G are sentinels for t = -1 and t = T.
  auto owner = [&](int t) -> int {
    if (t < 0) return -1;
    if (t >= T) return G;
    if (n_live == 0) return 0;
    return (int)min((long long)G - 1, (long long)offsets[t] * G / n_live);
  };
  for (int t = tid; t <= T; t += nt) {
    const int here = owner(t), before = owner(t - 1);
    if (before < g && g <= here) { s_t0 = t; s_e0 = offsets[t]; }
    if (before < g + 1 && g + 1 <= here) { s_t1 = t; s_e1 = offsets[t]; }
  }
  for (int i = tid; i < n_row_words / 4; i += nt)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = n_row_words / 4 * 4 + tid; i < n_row_words; i += nt) smem[i] = 0.0f;
  __syncthreads();
  const int t0 = s_t0, t1 = s_t1;

  // partition p's slots and loads; row is its topic's row in [c0, c0 + kt)
  // or -1
  auto fetch = [&](int p, int c0, int kt, Entry& x) {
    x.p = p;
    x.lead = leader_slot[p];
    x.row = kt > 0 ? partition_topic[p] - c0 : -1;
#pragma unroll
    for (int r = 0; r < kRes; ++r) {
      x.ll[r] = leader_load[(size_t)r * P + p];
      x.fl[r] = follower_load[(size_t)r * P + p];
    }
#pragma unroll
    for (int s = 0; s < kMaxR; ++s) {
      x.b[s] = s < R ? assignment[(size_t)p * R + s] : -1;
      x.d[s] = s < R ? replica_disk[(size_t)p * R + s] : -1;
    }
    if (x.row >= kt) x.row = -1;
  };
  // one replica in slot s on broker b, disk d: into this tile's rows
  auto add_slot = [&](const Entry& x, int s, int b, int d) {
    const int j = b - b_lo;
    if (b < 0 || b >= B || j < 0 || j >= bt) return;
    const bool is_lead = (s == x.lead);
    float* const cell = row_base + (kSharedRows ? j : b);
#pragma unroll
    for (int r = 0; r < kRes; ++r) atomicAdd(cell + r * stride, is_lead ? x.ll[r] : x.fl[r]);
    atomicAdd(cell + kPot * stride, x.ll[kNwOut]);
    atomicAdd(reinterpret_cast<int32_t*>(cell + kRc * stride), 1);
    if (is_lead) {
      atomicAdd(reinterpret_cast<int32_t*>(cell + kLc * stride), 1);
      atomicAdd(cell + kLbi * stride, x.ll[kNwIn]);
    }
    if (x.row >= 0) {
      atomicAdd(&s_topic[(2 * x.row) * BT + j], 1);
      if (is_lead) atomicAdd(&s_topic[(2 * x.row + 1) * BT + j], 1);
    }
    if (d >= 0 && d < D)
      atomicAdd(row_base + kRows * stride + (kSharedRows ? j : b) * D + d,
                is_lead ? x.ll[kDisk] : x.fl[kDisk]);
  };
  auto add = [&](const Entry& x) {
#pragma unroll
    for (int s = 0; s < kMaxR; ++s) add_slot(x, s, x.b[s], x.d[s]);
    for (int s = kMaxR; s < R; ++s)
      add_slot(x, s, assignment[(size_t)x.p * R + s], replica_disk[(size_t)x.p * R + s]);
  };
  // index entries [e_lo, e_hi)
  auto add_range = [&](int e_lo, int e_hi, int c0, int kt) {
    for (int e = e_lo + tid; e < e_hi; e += nt) {
      Entry x;
      fetch(order[e], c0, kt, x);
      add(x);
    }
  };

  // the owned topics, KT at a time
  const bool vec = (B % 4 == 0) && (BT % 4 == 0);
  for (int c0 = t0; c0 < t1; c0 += KT) {
    const int c1 = min(c0 + KT, t1), kt = c1 - c0;
    for (int i = tid; i < 2 * kt * BT; i += nt) s_topic[i] = 0;
    const int e_lo = c0 == t0 ? s_e0 : offsets[c0];
    const int e_hi = c1 == t1 ? s_e1 : offsets[c1];
    __syncthreads();
    add_range(e_lo, e_hi, c0, kt);
    __syncthreads();
    // every cell of the owned rows on this tile, zeros included
    if (vec) {
      const int q = bt / 4;
      for (int i = tid; i < 2 * kt * q; i += nt) {
        const int r2 = i / q, k = i - r2 * q;
        const int4 v = reinterpret_cast<const int4*>(s_topic + r2 * BT)[k];
        const size_t at = ((size_t)(r2 & 1) * T + c0 + (r2 >> 1)) * B + b_lo;
        reinterpret_cast<int4*>(topic_counts + at)[k] = v;
      }
    } else {
      for (int i = tid; i < 2 * kt * bt; i += nt) {
        const int r2 = i / bt, k = i - r2 * bt;
        const size_t at = ((size_t)(r2 & 1) * T + c0 + (r2 >> 1)) * B + b_lo;
        topic_counts[at + k] = s_topic[r2 * BT + k];
      }
    }
    __syncthreads();
  }
  // live partitions whose topic is out of range count everywhere but in
  // the topic rows; the last group takes them
  if (g == G - 1) add_range(s_e1, n_live, 0, 0);

  if constexpr (kSharedRows) {
    // sum the cluster's rows, each block one slice, and add them to the
    // output
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = (int)cluster.block_rank();
    for (int i = rank * nt + tid; i < n_row_words; i += kCluster * nt) {
      int j, at, k = -1;
      if (i < kRows * BT) {
        k = i / BT;
        j = i - k * BT;
        at = k * B + b_lo + j;
      } else {
        const int x = i - kRows * BT;
        j = x / D;
        at = kRows * B + b_lo * D + x;
      }
      if (j >= bt) continue;
      if (k == kRc || k == kLc) {
        int sum = 0;
#pragma unroll
        for (int q = 0; q < kCluster; ++q)
          sum += reinterpret_cast<const int32_t*>(cluster.map_shared_rank(smem, q))[i];
        if (sum != 0) atomicAdd(reinterpret_cast<int32_t*>(rows) + at, sum);
      } else {
        float sum = 0.0f;
#pragma unroll
        for (int q = 0; q < kCluster; ++q) sum += cluster.map_shared_rank(smem, q)[i];
        if (sum != 0.0f) atomicAdd(rows + at, sum);
      }
    }
    // no block leaves while another may still read its shared memory
    cluster.sync();
  }
}

struct DeviceInfo {
  bool ready = false;
  int smem_budget = 0;              // dynamic shared bytes of one block
  int occupancy_smem[2] = {-1, -1}; // per kSharedRows: the shared bytes of
  int clusters[2] = {0, 0};         // the last plan, and its co-resident clusters
};
DeviceInfo g_devices[kMaxDevices];

// How one call runs.
struct Plan {
  int shared_rows;  // which kernel: rows in shared memory (1) or global (0)
  int tiles, BT;    // broker tiles (gridDim.y) and their width
  int KT;           // topics per pass
  int groups;       // blocks per tile (gridDim.x), a multiple of kCluster
  int smem;         // dynamic shared bytes of a block
};

cudaLaunchConfig_t launch_config(const Plan& p, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.groups, p.tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The plan of one kernel: the widest broker tile whose words per broker fit
// in the budget beside one topic's two rows, the topics per pass, and the
// grid of every co-resident cluster shared among the tiles.
cudaError_t layout(DeviceInfo& info, bool shared_rows, int B, int T, int D, Plan& p) {
  const int row_words = shared_rows ? kRows + D : 0;
  const long long per_broker = (long long)(row_words + 2) * 4;
  p.shared_rows = shared_rows;
  p.BT = B;
  p.tiles = 1;
  if ((long long)B * per_broker > info.smem_budget) {
    const int most = (int)(info.smem_budget / per_broker) & ~3;
    if (most < 4) return cudaErrorInvalidValue;
    p.tiles = (B + most - 1) / most;
    p.BT = ((B + p.tiles - 1) / p.tiles + 3) & ~3;
  }
  const long long kt = (info.smem_budget - (long long)row_words * p.BT * 4) / (2LL * p.BT * 4);
  p.KT = (int)(kt < T ? kt : T);
  p.smem = (row_words + 2 * p.KT) * p.BT * 4;
  if (info.occupancy_smem[shared_rows] != p.smem) {
    p.groups = kCluster;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(p, nullptr, attr);
    int clusters = 0;
    const cudaError_t err = shared_rows
        ? cudaOccupancyMaxActiveClusters(&clusters, broker_aggregates_kernel<true>, &cfg)
        : cudaOccupancyMaxActiveClusters(&clusters, broker_aggregates_kernel<false>, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    info.clusters[shared_rows] = clusters;
    info.occupancy_smem[shared_rows] = p.smem;
  }
  const int per_tile = info.clusters[shared_rows] / p.tiles;
  p.groups = (per_tile > 0 ? per_tile : 1) * kCluster;
  return cudaSuccess;
}

// rows: 1 shared, 0 global, -1 chosen here. Shared rows pay for zeroing
// and reducing a block's cells when the block adds at least as many
// replica slots (n_live * R over the grid) as it holds brokers (BT).
cudaError_t plan(int n_live, int R, int B, int T, int D, int device, int rows, Plan& p) {
  if (device < 0 || device >= kMaxDevices || !g_devices[device].ready)
    return cudaErrorInitializationError;
  if (B < 1 || T < 1 || D < 1 || rows < -1 || rows > 1) return cudaErrorInvalidValue;
  DeviceInfo& info = g_devices[device];
  if (rows != 0) {
    const cudaError_t err = layout(info, true, B, T, D, p);
    if (rows == 1) return err;
    if (err == cudaSuccess &&
        (long long)n_live * R >= (long long)p.groups * p.tiles * p.BT)
      return cudaSuccess;
  }
  return layout(info, false, B, T, D, p);
}

}  // namespace

// Once per device, with that device current: the shared-memory budget of a
// block (kBlocksPerSm blocks per SM) and the kernels' dynamic shared-memory
// limit.
extern "C" int ccx_broker_aggregates_init(int device) {
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int per_sm = 0, optin = 0, reserved = 0;
  cudaError_t err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  cudaFuncAttributes shared_attr, global_attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&shared_attr, broker_aggregates_kernel<true>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&global_attr, broker_aggregates_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  const size_t static_smem = shared_attr.sharedSizeBytes > global_attr.sharedSizeBytes
      ? shared_attr.sharedSizeBytes : global_attr.sharedSizeBytes;
  int budget = per_sm / kBlocksPerSm - reserved - (int)static_smem;
  if (budget > optin) budget = optin;
  budget &= ~15;
  err = cudaFuncSetAttribute(broker_aggregates_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(broker_aggregates_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
  if (err != cudaSuccess) return (int)err;
  g_devices[device] = DeviceInfo{};
  g_devices[device].ready = true;
  g_devices[device].smem_budget = budget;
  return 0;
}

// The plan of a call with these sizes, as int[6]: shared rows (1) or global
// (0), tiles, broker tile width, topics per pass, blocks per tile, dynamic
// shared bytes.
extern "C" int ccx_broker_aggregates_plan(int n_live, int R, int B, int T, int D,
                                          int device, int rows, int* out) {
  Plan p;
  const cudaError_t err = plan(n_live, R, B, T, D, device, rows, p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.shared_rows;
  out[1] = p.tiles;
  out[2] = p.BT;
  out[3] = p.KT;
  out[4] = p.groups;
  out[5] = p.smem;
  return 0;
}

// out: int32 words [2 * T * B] topic counts, then the rows [8 * B + B * D]
// that the kernel adds into (zeroed here with one memset).
extern "C" int ccx_broker_aggregates(
    const void* order, const void* offsets, int n_live,
    const void* assignment, const void* leader_slot, const void* replica_disk,
    const void* partition_topic, const void* leader_load, const void* follower_load,
    int P, int R, int B, int T, int D, int rows_mode, void* out, int device, void* stream) {
  Plan p;
  cudaError_t err = plan(n_live, R, B, T, D, device, rows_mode, p);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(p, s, attr);

  int32_t* topic_counts = static_cast<int32_t*>(out);
  float* rows = reinterpret_cast<float*>(topic_counts + 2 * (size_t)T * B);
  err = cudaMemsetAsync(rows, 0, ((size_t)kRows * B + (size_t)B * D) * 4, s);
  if (err != cudaSuccess) return (int)err;
  auto* kernel = p.shared_rows ? &broker_aggregates_kernel<true> : &broker_aggregates_kernel<false>;
  err = cudaLaunchKernelEx(
      &cfg, kernel,
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(offsets), n_live,
      static_cast<const int32_t*>(assignment), static_cast<const int32_t*>(leader_slot),
      static_cast<const int32_t*>(replica_disk), static_cast<const int32_t*>(partition_topic),
      static_cast<const float*>(leader_load), static_cast<const float*>(follower_load),
      P, R, B, T, D, p.BT, p.KT, topic_counts, rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
