// Sorting networks for csrc/coord_stats.cu and csrc/krum_select.cu.
// Generated by src/repro_torch/kernels/coord_stats/networks.py (Batcher's
// merge-exchange sort); do not edit: run
//     PYTHONPATH=src python -m repro_torch.kernels.coord_stats.networks
// sort_net(k) sorts the keys k[0..N) ascending with min/max compare-exchanges,
// every index a compile-time constant, so k stays in registers.

#pragma once

__device__ __forceinline__ void sort_cx(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

__device__ __forceinline__ void sort_net(float (&)[1]) {}

// n = 2: 1 comparators
__device__ __forceinline__ void sort_net(float (&k)[2]) {
  sort_cx(k[0], k[1]);
}

// n = 3: 3 comparators
__device__ __forceinline__ void sort_net(float (&k)[3]) {
  sort_cx(k[0], k[2]); sort_cx(k[0], k[1]); sort_cx(k[1], k[2]);
}

// n = 4: 5 comparators
__device__ __forceinline__ void sort_net(float (&k)[4]) {
  sort_cx(k[0], k[2]); sort_cx(k[1], k[3]); sort_cx(k[0], k[1]); sort_cx(k[2], k[3]);
  sort_cx(k[1], k[2]);
}

// n = 5: 9 comparators
__device__ __forceinline__ void sort_net(float (&k)[5]) {
  sort_cx(k[0], k[4]); sort_cx(k[0], k[2]); sort_cx(k[1], k[3]); sort_cx(k[2], k[4]);
  sort_cx(k[0], k[1]); sort_cx(k[2], k[3]); sort_cx(k[1], k[4]); sort_cx(k[1], k[2]);
  sort_cx(k[3], k[4]);
}

// n = 6: 12 comparators
__device__ __forceinline__ void sort_net(float (&k)[6]) {
  sort_cx(k[0], k[4]); sort_cx(k[1], k[5]); sort_cx(k[0], k[2]); sort_cx(k[1], k[3]);
  sort_cx(k[2], k[4]); sort_cx(k[3], k[5]); sort_cx(k[0], k[1]); sort_cx(k[2], k[3]);
  sort_cx(k[4], k[5]); sort_cx(k[1], k[4]); sort_cx(k[1], k[2]); sort_cx(k[3], k[4]);
}

// n = 7: 16 comparators
__device__ __forceinline__ void sort_net(float (&k)[7]) {
  sort_cx(k[0], k[4]); sort_cx(k[1], k[5]); sort_cx(k[2], k[6]); sort_cx(k[0], k[2]);
  sort_cx(k[1], k[3]); sort_cx(k[4], k[6]); sort_cx(k[2], k[4]); sort_cx(k[3], k[5]);
  sort_cx(k[0], k[1]); sort_cx(k[2], k[3]); sort_cx(k[4], k[5]); sort_cx(k[1], k[4]);
  sort_cx(k[3], k[6]); sort_cx(k[1], k[2]); sort_cx(k[3], k[4]); sort_cx(k[5], k[6]);
}

// n = 8: 19 comparators
__device__ __forceinline__ void sort_net(float (&k)[8]) {
  sort_cx(k[0], k[4]); sort_cx(k[1], k[5]); sort_cx(k[2], k[6]); sort_cx(k[3], k[7]);
  sort_cx(k[0], k[2]); sort_cx(k[1], k[3]); sort_cx(k[4], k[6]); sort_cx(k[5], k[7]);
  sort_cx(k[2], k[4]); sort_cx(k[3], k[5]); sort_cx(k[0], k[1]); sort_cx(k[2], k[3]);
  sort_cx(k[4], k[5]); sort_cx(k[6], k[7]); sort_cx(k[1], k[4]); sort_cx(k[3], k[6]);
  sort_cx(k[1], k[2]); sort_cx(k[3], k[4]); sort_cx(k[5], k[6]);
}

// n = 9: 26 comparators
__device__ __forceinline__ void sort_net(float (&k)[9]) {
  sort_cx(k[0], k[8]); sort_cx(k[0], k[4]); sort_cx(k[1], k[5]); sort_cx(k[2], k[6]);
  sort_cx(k[3], k[7]); sort_cx(k[4], k[8]); sort_cx(k[0], k[2]); sort_cx(k[1], k[3]);
  sort_cx(k[4], k[6]); sort_cx(k[5], k[7]); sort_cx(k[2], k[8]); sort_cx(k[2], k[4]);
  sort_cx(k[3], k[5]); sort_cx(k[6], k[8]); sort_cx(k[0], k[1]); sort_cx(k[2], k[3]);
  sort_cx(k[4], k[5]); sort_cx(k[6], k[7]); sort_cx(k[1], k[8]); sort_cx(k[1], k[4]);
  sort_cx(k[3], k[6]); sort_cx(k[5], k[8]); sort_cx(k[1], k[2]); sort_cx(k[3], k[4]);
  sort_cx(k[5], k[6]); sort_cx(k[7], k[8]);
}

// n = 10: 31 comparators
__device__ __forceinline__ void sort_net(float (&k)[10]) {
  sort_cx(k[0], k[8]); sort_cx(k[1], k[9]); sort_cx(k[0], k[4]); sort_cx(k[1], k[5]);
  sort_cx(k[2], k[6]); sort_cx(k[3], k[7]); sort_cx(k[4], k[8]); sort_cx(k[5], k[9]);
  sort_cx(k[0], k[2]); sort_cx(k[1], k[3]); sort_cx(k[4], k[6]); sort_cx(k[5], k[7]);
  sort_cx(k[2], k[8]); sort_cx(k[3], k[9]); sort_cx(k[2], k[4]); sort_cx(k[3], k[5]);
  sort_cx(k[6], k[8]); sort_cx(k[7], k[9]); sort_cx(k[0], k[1]); sort_cx(k[2], k[3]);
  sort_cx(k[4], k[5]); sort_cx(k[6], k[7]); sort_cx(k[8], k[9]); sort_cx(k[1], k[8]);
  sort_cx(k[1], k[4]); sort_cx(k[3], k[6]); sort_cx(k[5], k[8]); sort_cx(k[1], k[2]);
  sort_cx(k[3], k[4]); sort_cx(k[5], k[6]); sort_cx(k[7], k[8]);
}

// n = 11: 37 comparators
__device__ __forceinline__ void sort_net(float (&k)[11]) {
  sort_cx(k[0], k[8]); sort_cx(k[1], k[9]); sort_cx(k[2], k[10]); sort_cx(k[0], k[4]);
  sort_cx(k[1], k[5]); sort_cx(k[2], k[6]); sort_cx(k[3], k[7]); sort_cx(k[4], k[8]);
  sort_cx(k[5], k[9]); sort_cx(k[6], k[10]); sort_cx(k[0], k[2]); sort_cx(k[1], k[3]);
  sort_cx(k[4], k[6]); sort_cx(k[5], k[7]); sort_cx(k[8], k[10]); sort_cx(k[2], k[8]);
  sort_cx(k[3], k[9]); sort_cx(k[2], k[4]); sort_cx(k[3], k[5]); sort_cx(k[6], k[8]);
  sort_cx(k[7], k[9]); sort_cx(k[0], k[1]); sort_cx(k[2], k[3]); sort_cx(k[4], k[5]);
  sort_cx(k[6], k[7]); sort_cx(k[8], k[9]); sort_cx(k[1], k[8]); sort_cx(k[3], k[10]);
  sort_cx(k[1], k[4]); sort_cx(k[3], k[6]); sort_cx(k[5], k[8]); sort_cx(k[7], k[10]);
  sort_cx(k[1], k[2]); sort_cx(k[3], k[4]); sort_cx(k[5], k[6]); sort_cx(k[7], k[8]);
  sort_cx(k[9], k[10]);
}

// n = 12: 41 comparators
__device__ __forceinline__ void sort_net(float (&k)[12]) {
  sort_cx(k[0], k[8]); sort_cx(k[1], k[9]); sort_cx(k[2], k[10]); sort_cx(k[3], k[11]);
  sort_cx(k[0], k[4]); sort_cx(k[1], k[5]); sort_cx(k[2], k[6]); sort_cx(k[3], k[7]);
  sort_cx(k[4], k[8]); sort_cx(k[5], k[9]); sort_cx(k[6], k[10]); sort_cx(k[7], k[11]);
  sort_cx(k[0], k[2]); sort_cx(k[1], k[3]); sort_cx(k[4], k[6]); sort_cx(k[5], k[7]);
  sort_cx(k[8], k[10]); sort_cx(k[9], k[11]); sort_cx(k[2], k[8]); sort_cx(k[3], k[9]);
  sort_cx(k[2], k[4]); sort_cx(k[3], k[5]); sort_cx(k[6], k[8]); sort_cx(k[7], k[9]);
  sort_cx(k[0], k[1]); sort_cx(k[2], k[3]); sort_cx(k[4], k[5]); sort_cx(k[6], k[7]);
  sort_cx(k[8], k[9]); sort_cx(k[10], k[11]); sort_cx(k[1], k[8]); sort_cx(k[3], k[10]);
  sort_cx(k[1], k[4]); sort_cx(k[3], k[6]); sort_cx(k[5], k[8]); sort_cx(k[7], k[10]);
  sort_cx(k[1], k[2]); sort_cx(k[3], k[4]); sort_cx(k[5], k[6]); sort_cx(k[7], k[8]);
  sort_cx(k[9], k[10]);
}

// n = 13: 48 comparators
__device__ __forceinline__ void sort_net(float (&k)[13]) {
  sort_cx(k[0], k[8]); sort_cx(k[1], k[9]); sort_cx(k[2], k[10]); sort_cx(k[3], k[11]);
  sort_cx(k[4], k[12]); sort_cx(k[0], k[4]); sort_cx(k[1], k[5]); sort_cx(k[2], k[6]);
  sort_cx(k[3], k[7]); sort_cx(k[8], k[12]); sort_cx(k[4], k[8]); sort_cx(k[5], k[9]);
  sort_cx(k[6], k[10]); sort_cx(k[7], k[11]); sort_cx(k[0], k[2]); sort_cx(k[1], k[3]);
  sort_cx(k[4], k[6]); sort_cx(k[5], k[7]); sort_cx(k[8], k[10]); sort_cx(k[9], k[11]);
  sort_cx(k[2], k[8]); sort_cx(k[3], k[9]); sort_cx(k[6], k[12]); sort_cx(k[2], k[4]);
  sort_cx(k[3], k[5]); sort_cx(k[6], k[8]); sort_cx(k[7], k[9]); sort_cx(k[10], k[12]);
  sort_cx(k[0], k[1]); sort_cx(k[2], k[3]); sort_cx(k[4], k[5]); sort_cx(k[6], k[7]);
  sort_cx(k[8], k[9]); sort_cx(k[10], k[11]); sort_cx(k[1], k[8]); sort_cx(k[3], k[10]);
  sort_cx(k[5], k[12]); sort_cx(k[1], k[4]); sort_cx(k[3], k[6]); sort_cx(k[5], k[8]);
  sort_cx(k[7], k[10]); sort_cx(k[9], k[12]); sort_cx(k[1], k[2]); sort_cx(k[3], k[4]);
  sort_cx(k[5], k[6]); sort_cx(k[7], k[8]); sort_cx(k[9], k[10]); sort_cx(k[11], k[12]);
}

// n = 14: 53 comparators
__device__ __forceinline__ void sort_net(float (&k)[14]) {
  sort_cx(k[0], k[8]); sort_cx(k[1], k[9]); sort_cx(k[2], k[10]); sort_cx(k[3], k[11]);
  sort_cx(k[4], k[12]); sort_cx(k[5], k[13]); sort_cx(k[0], k[4]); sort_cx(k[1], k[5]);
  sort_cx(k[2], k[6]); sort_cx(k[3], k[7]); sort_cx(k[8], k[12]); sort_cx(k[9], k[13]);
  sort_cx(k[4], k[8]); sort_cx(k[5], k[9]); sort_cx(k[6], k[10]); sort_cx(k[7], k[11]);
  sort_cx(k[0], k[2]); sort_cx(k[1], k[3]); sort_cx(k[4], k[6]); sort_cx(k[5], k[7]);
  sort_cx(k[8], k[10]); sort_cx(k[9], k[11]); sort_cx(k[2], k[8]); sort_cx(k[3], k[9]);
  sort_cx(k[6], k[12]); sort_cx(k[7], k[13]); sort_cx(k[2], k[4]); sort_cx(k[3], k[5]);
  sort_cx(k[6], k[8]); sort_cx(k[7], k[9]); sort_cx(k[10], k[12]); sort_cx(k[11], k[13]);
  sort_cx(k[0], k[1]); sort_cx(k[2], k[3]); sort_cx(k[4], k[5]); sort_cx(k[6], k[7]);
  sort_cx(k[8], k[9]); sort_cx(k[10], k[11]); sort_cx(k[12], k[13]); sort_cx(k[1], k[8]);
  sort_cx(k[3], k[10]); sort_cx(k[5], k[12]); sort_cx(k[1], k[4]); sort_cx(k[3], k[6]);
  sort_cx(k[5], k[8]); sort_cx(k[7], k[10]); sort_cx(k[9], k[12]); sort_cx(k[1], k[2]);
  sort_cx(k[3], k[4]); sort_cx(k[5], k[6]); sort_cx(k[7], k[8]); sort_cx(k[9], k[10]);
  sort_cx(k[11], k[12]);
}

// n = 15: 59 comparators
__device__ __forceinline__ void sort_net(float (&k)[15]) {
  sort_cx(k[0], k[8]); sort_cx(k[1], k[9]); sort_cx(k[2], k[10]); sort_cx(k[3], k[11]);
  sort_cx(k[4], k[12]); sort_cx(k[5], k[13]); sort_cx(k[6], k[14]); sort_cx(k[0], k[4]);
  sort_cx(k[1], k[5]); sort_cx(k[2], k[6]); sort_cx(k[3], k[7]); sort_cx(k[8], k[12]);
  sort_cx(k[9], k[13]); sort_cx(k[10], k[14]); sort_cx(k[4], k[8]); sort_cx(k[5], k[9]);
  sort_cx(k[6], k[10]); sort_cx(k[7], k[11]); sort_cx(k[0], k[2]); sort_cx(k[1], k[3]);
  sort_cx(k[4], k[6]); sort_cx(k[5], k[7]); sort_cx(k[8], k[10]); sort_cx(k[9], k[11]);
  sort_cx(k[12], k[14]); sort_cx(k[2], k[8]); sort_cx(k[3], k[9]); sort_cx(k[6], k[12]);
  sort_cx(k[7], k[13]); sort_cx(k[2], k[4]); sort_cx(k[3], k[5]); sort_cx(k[6], k[8]);
  sort_cx(k[7], k[9]); sort_cx(k[10], k[12]); sort_cx(k[11], k[13]); sort_cx(k[0], k[1]);
  sort_cx(k[2], k[3]); sort_cx(k[4], k[5]); sort_cx(k[6], k[7]); sort_cx(k[8], k[9]);
  sort_cx(k[10], k[11]); sort_cx(k[12], k[13]); sort_cx(k[1], k[8]); sort_cx(k[3], k[10]);
  sort_cx(k[5], k[12]); sort_cx(k[7], k[14]); sort_cx(k[1], k[4]); sort_cx(k[3], k[6]);
  sort_cx(k[5], k[8]); sort_cx(k[7], k[10]); sort_cx(k[9], k[12]); sort_cx(k[11], k[14]);
  sort_cx(k[1], k[2]); sort_cx(k[3], k[4]); sort_cx(k[5], k[6]); sort_cx(k[7], k[8]);
  sort_cx(k[9], k[10]); sort_cx(k[11], k[12]); sort_cx(k[13], k[14]);
}

// n = 16: 63 comparators
__device__ __forceinline__ void sort_net(float (&k)[16]) {
  sort_cx(k[0], k[8]); sort_cx(k[1], k[9]); sort_cx(k[2], k[10]); sort_cx(k[3], k[11]);
  sort_cx(k[4], k[12]); sort_cx(k[5], k[13]); sort_cx(k[6], k[14]); sort_cx(k[7], k[15]);
  sort_cx(k[0], k[4]); sort_cx(k[1], k[5]); sort_cx(k[2], k[6]); sort_cx(k[3], k[7]);
  sort_cx(k[8], k[12]); sort_cx(k[9], k[13]); sort_cx(k[10], k[14]); sort_cx(k[11], k[15]);
  sort_cx(k[4], k[8]); sort_cx(k[5], k[9]); sort_cx(k[6], k[10]); sort_cx(k[7], k[11]);
  sort_cx(k[0], k[2]); sort_cx(k[1], k[3]); sort_cx(k[4], k[6]); sort_cx(k[5], k[7]);
  sort_cx(k[8], k[10]); sort_cx(k[9], k[11]); sort_cx(k[12], k[14]); sort_cx(k[13], k[15]);
  sort_cx(k[2], k[8]); sort_cx(k[3], k[9]); sort_cx(k[6], k[12]); sort_cx(k[7], k[13]);
  sort_cx(k[2], k[4]); sort_cx(k[3], k[5]); sort_cx(k[6], k[8]); sort_cx(k[7], k[9]);
  sort_cx(k[10], k[12]); sort_cx(k[11], k[13]); sort_cx(k[0], k[1]); sort_cx(k[2], k[3]);
  sort_cx(k[4], k[5]); sort_cx(k[6], k[7]); sort_cx(k[8], k[9]); sort_cx(k[10], k[11]);
  sort_cx(k[12], k[13]); sort_cx(k[14], k[15]); sort_cx(k[1], k[8]); sort_cx(k[3], k[10]);
  sort_cx(k[5], k[12]); sort_cx(k[7], k[14]); sort_cx(k[1], k[4]); sort_cx(k[3], k[6]);
  sort_cx(k[5], k[8]); sort_cx(k[7], k[10]); sort_cx(k[9], k[12]); sort_cx(k[11], k[14]);
  sort_cx(k[1], k[2]); sort_cx(k[3], k[4]); sort_cx(k[5], k[6]); sort_cx(k[7], k[8]);
  sort_cx(k[9], k[10]); sort_cx(k[11], k[12]); sort_cx(k[13], k[14]);
}

// n = 32: 191 comparators
__device__ __forceinline__ void sort_net(float (&k)[32]) {
  sort_cx(k[0], k[16]); sort_cx(k[1], k[17]); sort_cx(k[2], k[18]); sort_cx(k[3], k[19]);
  sort_cx(k[4], k[20]); sort_cx(k[5], k[21]); sort_cx(k[6], k[22]); sort_cx(k[7], k[23]);
  sort_cx(k[8], k[24]); sort_cx(k[9], k[25]); sort_cx(k[10], k[26]); sort_cx(k[11], k[27]);
  sort_cx(k[12], k[28]); sort_cx(k[13], k[29]); sort_cx(k[14], k[30]); sort_cx(k[15], k[31]);
  sort_cx(k[0], k[8]); sort_cx(k[1], k[9]); sort_cx(k[2], k[10]); sort_cx(k[3], k[11]);
  sort_cx(k[4], k[12]); sort_cx(k[5], k[13]); sort_cx(k[6], k[14]); sort_cx(k[7], k[15]);
  sort_cx(k[16], k[24]); sort_cx(k[17], k[25]); sort_cx(k[18], k[26]); sort_cx(k[19], k[27]);
  sort_cx(k[20], k[28]); sort_cx(k[21], k[29]); sort_cx(k[22], k[30]); sort_cx(k[23], k[31]);
  sort_cx(k[8], k[16]); sort_cx(k[9], k[17]); sort_cx(k[10], k[18]); sort_cx(k[11], k[19]);
  sort_cx(k[12], k[20]); sort_cx(k[13], k[21]); sort_cx(k[14], k[22]); sort_cx(k[15], k[23]);
  sort_cx(k[0], k[4]); sort_cx(k[1], k[5]); sort_cx(k[2], k[6]); sort_cx(k[3], k[7]);
  sort_cx(k[8], k[12]); sort_cx(k[9], k[13]); sort_cx(k[10], k[14]); sort_cx(k[11], k[15]);
  sort_cx(k[16], k[20]); sort_cx(k[17], k[21]); sort_cx(k[18], k[22]); sort_cx(k[19], k[23]);
  sort_cx(k[24], k[28]); sort_cx(k[25], k[29]); sort_cx(k[26], k[30]); sort_cx(k[27], k[31]);
  sort_cx(k[4], k[16]); sort_cx(k[5], k[17]); sort_cx(k[6], k[18]); sort_cx(k[7], k[19]);
  sort_cx(k[12], k[24]); sort_cx(k[13], k[25]); sort_cx(k[14], k[26]); sort_cx(k[15], k[27]);
  sort_cx(k[4], k[8]); sort_cx(k[5], k[9]); sort_cx(k[6], k[10]); sort_cx(k[7], k[11]);
  sort_cx(k[12], k[16]); sort_cx(k[13], k[17]); sort_cx(k[14], k[18]); sort_cx(k[15], k[19]);
  sort_cx(k[20], k[24]); sort_cx(k[21], k[25]); sort_cx(k[22], k[26]); sort_cx(k[23], k[27]);
  sort_cx(k[0], k[2]); sort_cx(k[1], k[3]); sort_cx(k[4], k[6]); sort_cx(k[5], k[7]);
  sort_cx(k[8], k[10]); sort_cx(k[9], k[11]); sort_cx(k[12], k[14]); sort_cx(k[13], k[15]);
  sort_cx(k[16], k[18]); sort_cx(k[17], k[19]); sort_cx(k[20], k[22]); sort_cx(k[21], k[23]);
  sort_cx(k[24], k[26]); sort_cx(k[25], k[27]); sort_cx(k[28], k[30]); sort_cx(k[29], k[31]);
  sort_cx(k[2], k[16]); sort_cx(k[3], k[17]); sort_cx(k[6], k[20]); sort_cx(k[7], k[21]);
  sort_cx(k[10], k[24]); sort_cx(k[11], k[25]); sort_cx(k[14], k[28]); sort_cx(k[15], k[29]);
  sort_cx(k[2], k[8]); sort_cx(k[3], k[9]); sort_cx(k[6], k[12]); sort_cx(k[7], k[13]);
  sort_cx(k[10], k[16]); sort_cx(k[11], k[17]); sort_cx(k[14], k[20]); sort_cx(k[15], k[21]);
  sort_cx(k[18], k[24]); sort_cx(k[19], k[25]); sort_cx(k[22], k[28]); sort_cx(k[23], k[29]);
  sort_cx(k[2], k[4]); sort_cx(k[3], k[5]); sort_cx(k[6], k[8]); sort_cx(k[7], k[9]);
  sort_cx(k[10], k[12]); sort_cx(k[11], k[13]); sort_cx(k[14], k[16]); sort_cx(k[15], k[17]);
  sort_cx(k[18], k[20]); sort_cx(k[19], k[21]); sort_cx(k[22], k[24]); sort_cx(k[23], k[25]);
  sort_cx(k[26], k[28]); sort_cx(k[27], k[29]); sort_cx(k[0], k[1]); sort_cx(k[2], k[3]);
  sort_cx(k[4], k[5]); sort_cx(k[6], k[7]); sort_cx(k[8], k[9]); sort_cx(k[10], k[11]);
  sort_cx(k[12], k[13]); sort_cx(k[14], k[15]); sort_cx(k[16], k[17]); sort_cx(k[18], k[19]);
  sort_cx(k[20], k[21]); sort_cx(k[22], k[23]); sort_cx(k[24], k[25]); sort_cx(k[26], k[27]);
  sort_cx(k[28], k[29]); sort_cx(k[30], k[31]); sort_cx(k[1], k[16]); sort_cx(k[3], k[18]);
  sort_cx(k[5], k[20]); sort_cx(k[7], k[22]); sort_cx(k[9], k[24]); sort_cx(k[11], k[26]);
  sort_cx(k[13], k[28]); sort_cx(k[15], k[30]); sort_cx(k[1], k[8]); sort_cx(k[3], k[10]);
  sort_cx(k[5], k[12]); sort_cx(k[7], k[14]); sort_cx(k[9], k[16]); sort_cx(k[11], k[18]);
  sort_cx(k[13], k[20]); sort_cx(k[15], k[22]); sort_cx(k[17], k[24]); sort_cx(k[19], k[26]);
  sort_cx(k[21], k[28]); sort_cx(k[23], k[30]); sort_cx(k[1], k[4]); sort_cx(k[3], k[6]);
  sort_cx(k[5], k[8]); sort_cx(k[7], k[10]); sort_cx(k[9], k[12]); sort_cx(k[11], k[14]);
  sort_cx(k[13], k[16]); sort_cx(k[15], k[18]); sort_cx(k[17], k[20]); sort_cx(k[19], k[22]);
  sort_cx(k[21], k[24]); sort_cx(k[23], k[26]); sort_cx(k[25], k[28]); sort_cx(k[27], k[30]);
  sort_cx(k[1], k[2]); sort_cx(k[3], k[4]); sort_cx(k[5], k[6]); sort_cx(k[7], k[8]);
  sort_cx(k[9], k[10]); sort_cx(k[11], k[12]); sort_cx(k[13], k[14]); sort_cx(k[15], k[16]);
  sort_cx(k[17], k[18]); sort_cx(k[19], k[20]); sort_cx(k[21], k[22]); sort_cx(k[23], k[24]);
  sort_cx(k[25], k[26]); sort_cx(k[27], k[28]); sort_cx(k[29], k[30]);
}

// n = 64: 543 comparators
__device__ __forceinline__ void sort_net(float (&k)[64]) {
  sort_cx(k[0], k[32]); sort_cx(k[1], k[33]); sort_cx(k[2], k[34]); sort_cx(k[3], k[35]);
  sort_cx(k[4], k[36]); sort_cx(k[5], k[37]); sort_cx(k[6], k[38]); sort_cx(k[7], k[39]);
  sort_cx(k[8], k[40]); sort_cx(k[9], k[41]); sort_cx(k[10], k[42]); sort_cx(k[11], k[43]);
  sort_cx(k[12], k[44]); sort_cx(k[13], k[45]); sort_cx(k[14], k[46]); sort_cx(k[15], k[47]);
  sort_cx(k[16], k[48]); sort_cx(k[17], k[49]); sort_cx(k[18], k[50]); sort_cx(k[19], k[51]);
  sort_cx(k[20], k[52]); sort_cx(k[21], k[53]); sort_cx(k[22], k[54]); sort_cx(k[23], k[55]);
  sort_cx(k[24], k[56]); sort_cx(k[25], k[57]); sort_cx(k[26], k[58]); sort_cx(k[27], k[59]);
  sort_cx(k[28], k[60]); sort_cx(k[29], k[61]); sort_cx(k[30], k[62]); sort_cx(k[31], k[63]);
  sort_cx(k[0], k[16]); sort_cx(k[1], k[17]); sort_cx(k[2], k[18]); sort_cx(k[3], k[19]);
  sort_cx(k[4], k[20]); sort_cx(k[5], k[21]); sort_cx(k[6], k[22]); sort_cx(k[7], k[23]);
  sort_cx(k[8], k[24]); sort_cx(k[9], k[25]); sort_cx(k[10], k[26]); sort_cx(k[11], k[27]);
  sort_cx(k[12], k[28]); sort_cx(k[13], k[29]); sort_cx(k[14], k[30]); sort_cx(k[15], k[31]);
  sort_cx(k[32], k[48]); sort_cx(k[33], k[49]); sort_cx(k[34], k[50]); sort_cx(k[35], k[51]);
  sort_cx(k[36], k[52]); sort_cx(k[37], k[53]); sort_cx(k[38], k[54]); sort_cx(k[39], k[55]);
  sort_cx(k[40], k[56]); sort_cx(k[41], k[57]); sort_cx(k[42], k[58]); sort_cx(k[43], k[59]);
  sort_cx(k[44], k[60]); sort_cx(k[45], k[61]); sort_cx(k[46], k[62]); sort_cx(k[47], k[63]);
  sort_cx(k[16], k[32]); sort_cx(k[17], k[33]); sort_cx(k[18], k[34]); sort_cx(k[19], k[35]);
  sort_cx(k[20], k[36]); sort_cx(k[21], k[37]); sort_cx(k[22], k[38]); sort_cx(k[23], k[39]);
  sort_cx(k[24], k[40]); sort_cx(k[25], k[41]); sort_cx(k[26], k[42]); sort_cx(k[27], k[43]);
  sort_cx(k[28], k[44]); sort_cx(k[29], k[45]); sort_cx(k[30], k[46]); sort_cx(k[31], k[47]);
  sort_cx(k[0], k[8]); sort_cx(k[1], k[9]); sort_cx(k[2], k[10]); sort_cx(k[3], k[11]);
  sort_cx(k[4], k[12]); sort_cx(k[5], k[13]); sort_cx(k[6], k[14]); sort_cx(k[7], k[15]);
  sort_cx(k[16], k[24]); sort_cx(k[17], k[25]); sort_cx(k[18], k[26]); sort_cx(k[19], k[27]);
  sort_cx(k[20], k[28]); sort_cx(k[21], k[29]); sort_cx(k[22], k[30]); sort_cx(k[23], k[31]);
  sort_cx(k[32], k[40]); sort_cx(k[33], k[41]); sort_cx(k[34], k[42]); sort_cx(k[35], k[43]);
  sort_cx(k[36], k[44]); sort_cx(k[37], k[45]); sort_cx(k[38], k[46]); sort_cx(k[39], k[47]);
  sort_cx(k[48], k[56]); sort_cx(k[49], k[57]); sort_cx(k[50], k[58]); sort_cx(k[51], k[59]);
  sort_cx(k[52], k[60]); sort_cx(k[53], k[61]); sort_cx(k[54], k[62]); sort_cx(k[55], k[63]);
  sort_cx(k[8], k[32]); sort_cx(k[9], k[33]); sort_cx(k[10], k[34]); sort_cx(k[11], k[35]);
  sort_cx(k[12], k[36]); sort_cx(k[13], k[37]); sort_cx(k[14], k[38]); sort_cx(k[15], k[39]);
  sort_cx(k[24], k[48]); sort_cx(k[25], k[49]); sort_cx(k[26], k[50]); sort_cx(k[27], k[51]);
  sort_cx(k[28], k[52]); sort_cx(k[29], k[53]); sort_cx(k[30], k[54]); sort_cx(k[31], k[55]);
  sort_cx(k[8], k[16]); sort_cx(k[9], k[17]); sort_cx(k[10], k[18]); sort_cx(k[11], k[19]);
  sort_cx(k[12], k[20]); sort_cx(k[13], k[21]); sort_cx(k[14], k[22]); sort_cx(k[15], k[23]);
  sort_cx(k[24], k[32]); sort_cx(k[25], k[33]); sort_cx(k[26], k[34]); sort_cx(k[27], k[35]);
  sort_cx(k[28], k[36]); sort_cx(k[29], k[37]); sort_cx(k[30], k[38]); sort_cx(k[31], k[39]);
  sort_cx(k[40], k[48]); sort_cx(k[41], k[49]); sort_cx(k[42], k[50]); sort_cx(k[43], k[51]);
  sort_cx(k[44], k[52]); sort_cx(k[45], k[53]); sort_cx(k[46], k[54]); sort_cx(k[47], k[55]);
  sort_cx(k[0], k[4]); sort_cx(k[1], k[5]); sort_cx(k[2], k[6]); sort_cx(k[3], k[7]);
  sort_cx(k[8], k[12]); sort_cx(k[9], k[13]); sort_cx(k[10], k[14]); sort_cx(k[11], k[15]);
  sort_cx(k[16], k[20]); sort_cx(k[17], k[21]); sort_cx(k[18], k[22]); sort_cx(k[19], k[23]);
  sort_cx(k[24], k[28]); sort_cx(k[25], k[29]); sort_cx(k[26], k[30]); sort_cx(k[27], k[31]);
  sort_cx(k[32], k[36]); sort_cx(k[33], k[37]); sort_cx(k[34], k[38]); sort_cx(k[35], k[39]);
  sort_cx(k[40], k[44]); sort_cx(k[41], k[45]); sort_cx(k[42], k[46]); sort_cx(k[43], k[47]);
  sort_cx(k[48], k[52]); sort_cx(k[49], k[53]); sort_cx(k[50], k[54]); sort_cx(k[51], k[55]);
  sort_cx(k[56], k[60]); sort_cx(k[57], k[61]); sort_cx(k[58], k[62]); sort_cx(k[59], k[63]);
  sort_cx(k[4], k[32]); sort_cx(k[5], k[33]); sort_cx(k[6], k[34]); sort_cx(k[7], k[35]);
  sort_cx(k[12], k[40]); sort_cx(k[13], k[41]); sort_cx(k[14], k[42]); sort_cx(k[15], k[43]);
  sort_cx(k[20], k[48]); sort_cx(k[21], k[49]); sort_cx(k[22], k[50]); sort_cx(k[23], k[51]);
  sort_cx(k[28], k[56]); sort_cx(k[29], k[57]); sort_cx(k[30], k[58]); sort_cx(k[31], k[59]);
  sort_cx(k[4], k[16]); sort_cx(k[5], k[17]); sort_cx(k[6], k[18]); sort_cx(k[7], k[19]);
  sort_cx(k[12], k[24]); sort_cx(k[13], k[25]); sort_cx(k[14], k[26]); sort_cx(k[15], k[27]);
  sort_cx(k[20], k[32]); sort_cx(k[21], k[33]); sort_cx(k[22], k[34]); sort_cx(k[23], k[35]);
  sort_cx(k[28], k[40]); sort_cx(k[29], k[41]); sort_cx(k[30], k[42]); sort_cx(k[31], k[43]);
  sort_cx(k[36], k[48]); sort_cx(k[37], k[49]); sort_cx(k[38], k[50]); sort_cx(k[39], k[51]);
  sort_cx(k[44], k[56]); sort_cx(k[45], k[57]); sort_cx(k[46], k[58]); sort_cx(k[47], k[59]);
  sort_cx(k[4], k[8]); sort_cx(k[5], k[9]); sort_cx(k[6], k[10]); sort_cx(k[7], k[11]);
  sort_cx(k[12], k[16]); sort_cx(k[13], k[17]); sort_cx(k[14], k[18]); sort_cx(k[15], k[19]);
  sort_cx(k[20], k[24]); sort_cx(k[21], k[25]); sort_cx(k[22], k[26]); sort_cx(k[23], k[27]);
  sort_cx(k[28], k[32]); sort_cx(k[29], k[33]); sort_cx(k[30], k[34]); sort_cx(k[31], k[35]);
  sort_cx(k[36], k[40]); sort_cx(k[37], k[41]); sort_cx(k[38], k[42]); sort_cx(k[39], k[43]);
  sort_cx(k[44], k[48]); sort_cx(k[45], k[49]); sort_cx(k[46], k[50]); sort_cx(k[47], k[51]);
  sort_cx(k[52], k[56]); sort_cx(k[53], k[57]); sort_cx(k[54], k[58]); sort_cx(k[55], k[59]);
  sort_cx(k[0], k[2]); sort_cx(k[1], k[3]); sort_cx(k[4], k[6]); sort_cx(k[5], k[7]);
  sort_cx(k[8], k[10]); sort_cx(k[9], k[11]); sort_cx(k[12], k[14]); sort_cx(k[13], k[15]);
  sort_cx(k[16], k[18]); sort_cx(k[17], k[19]); sort_cx(k[20], k[22]); sort_cx(k[21], k[23]);
  sort_cx(k[24], k[26]); sort_cx(k[25], k[27]); sort_cx(k[28], k[30]); sort_cx(k[29], k[31]);
  sort_cx(k[32], k[34]); sort_cx(k[33], k[35]); sort_cx(k[36], k[38]); sort_cx(k[37], k[39]);
  sort_cx(k[40], k[42]); sort_cx(k[41], k[43]); sort_cx(k[44], k[46]); sort_cx(k[45], k[47]);
  sort_cx(k[48], k[50]); sort_cx(k[49], k[51]); sort_cx(k[52], k[54]); sort_cx(k[53], k[55]);
  sort_cx(k[56], k[58]); sort_cx(k[57], k[59]); sort_cx(k[60], k[62]); sort_cx(k[61], k[63]);
  sort_cx(k[2], k[32]); sort_cx(k[3], k[33]); sort_cx(k[6], k[36]); sort_cx(k[7], k[37]);
  sort_cx(k[10], k[40]); sort_cx(k[11], k[41]); sort_cx(k[14], k[44]); sort_cx(k[15], k[45]);
  sort_cx(k[18], k[48]); sort_cx(k[19], k[49]); sort_cx(k[22], k[52]); sort_cx(k[23], k[53]);
  sort_cx(k[26], k[56]); sort_cx(k[27], k[57]); sort_cx(k[30], k[60]); sort_cx(k[31], k[61]);
  sort_cx(k[2], k[16]); sort_cx(k[3], k[17]); sort_cx(k[6], k[20]); sort_cx(k[7], k[21]);
  sort_cx(k[10], k[24]); sort_cx(k[11], k[25]); sort_cx(k[14], k[28]); sort_cx(k[15], k[29]);
  sort_cx(k[18], k[32]); sort_cx(k[19], k[33]); sort_cx(k[22], k[36]); sort_cx(k[23], k[37]);
  sort_cx(k[26], k[40]); sort_cx(k[27], k[41]); sort_cx(k[30], k[44]); sort_cx(k[31], k[45]);
  sort_cx(k[34], k[48]); sort_cx(k[35], k[49]); sort_cx(k[38], k[52]); sort_cx(k[39], k[53]);
  sort_cx(k[42], k[56]); sort_cx(k[43], k[57]); sort_cx(k[46], k[60]); sort_cx(k[47], k[61]);
  sort_cx(k[2], k[8]); sort_cx(k[3], k[9]); sort_cx(k[6], k[12]); sort_cx(k[7], k[13]);
  sort_cx(k[10], k[16]); sort_cx(k[11], k[17]); sort_cx(k[14], k[20]); sort_cx(k[15], k[21]);
  sort_cx(k[18], k[24]); sort_cx(k[19], k[25]); sort_cx(k[22], k[28]); sort_cx(k[23], k[29]);
  sort_cx(k[26], k[32]); sort_cx(k[27], k[33]); sort_cx(k[30], k[36]); sort_cx(k[31], k[37]);
  sort_cx(k[34], k[40]); sort_cx(k[35], k[41]); sort_cx(k[38], k[44]); sort_cx(k[39], k[45]);
  sort_cx(k[42], k[48]); sort_cx(k[43], k[49]); sort_cx(k[46], k[52]); sort_cx(k[47], k[53]);
  sort_cx(k[50], k[56]); sort_cx(k[51], k[57]); sort_cx(k[54], k[60]); sort_cx(k[55], k[61]);
  sort_cx(k[2], k[4]); sort_cx(k[3], k[5]); sort_cx(k[6], k[8]); sort_cx(k[7], k[9]);
  sort_cx(k[10], k[12]); sort_cx(k[11], k[13]); sort_cx(k[14], k[16]); sort_cx(k[15], k[17]);
  sort_cx(k[18], k[20]); sort_cx(k[19], k[21]); sort_cx(k[22], k[24]); sort_cx(k[23], k[25]);
  sort_cx(k[26], k[28]); sort_cx(k[27], k[29]); sort_cx(k[30], k[32]); sort_cx(k[31], k[33]);
  sort_cx(k[34], k[36]); sort_cx(k[35], k[37]); sort_cx(k[38], k[40]); sort_cx(k[39], k[41]);
  sort_cx(k[42], k[44]); sort_cx(k[43], k[45]); sort_cx(k[46], k[48]); sort_cx(k[47], k[49]);
  sort_cx(k[50], k[52]); sort_cx(k[51], k[53]); sort_cx(k[54], k[56]); sort_cx(k[55], k[57]);
  sort_cx(k[58], k[60]); sort_cx(k[59], k[61]); sort_cx(k[0], k[1]); sort_cx(k[2], k[3]);
  sort_cx(k[4], k[5]); sort_cx(k[6], k[7]); sort_cx(k[8], k[9]); sort_cx(k[10], k[11]);
  sort_cx(k[12], k[13]); sort_cx(k[14], k[15]); sort_cx(k[16], k[17]); sort_cx(k[18], k[19]);
  sort_cx(k[20], k[21]); sort_cx(k[22], k[23]); sort_cx(k[24], k[25]); sort_cx(k[26], k[27]);
  sort_cx(k[28], k[29]); sort_cx(k[30], k[31]); sort_cx(k[32], k[33]); sort_cx(k[34], k[35]);
  sort_cx(k[36], k[37]); sort_cx(k[38], k[39]); sort_cx(k[40], k[41]); sort_cx(k[42], k[43]);
  sort_cx(k[44], k[45]); sort_cx(k[46], k[47]); sort_cx(k[48], k[49]); sort_cx(k[50], k[51]);
  sort_cx(k[52], k[53]); sort_cx(k[54], k[55]); sort_cx(k[56], k[57]); sort_cx(k[58], k[59]);
  sort_cx(k[60], k[61]); sort_cx(k[62], k[63]); sort_cx(k[1], k[32]); sort_cx(k[3], k[34]);
  sort_cx(k[5], k[36]); sort_cx(k[7], k[38]); sort_cx(k[9], k[40]); sort_cx(k[11], k[42]);
  sort_cx(k[13], k[44]); sort_cx(k[15], k[46]); sort_cx(k[17], k[48]); sort_cx(k[19], k[50]);
  sort_cx(k[21], k[52]); sort_cx(k[23], k[54]); sort_cx(k[25], k[56]); sort_cx(k[27], k[58]);
  sort_cx(k[29], k[60]); sort_cx(k[31], k[62]); sort_cx(k[1], k[16]); sort_cx(k[3], k[18]);
  sort_cx(k[5], k[20]); sort_cx(k[7], k[22]); sort_cx(k[9], k[24]); sort_cx(k[11], k[26]);
  sort_cx(k[13], k[28]); sort_cx(k[15], k[30]); sort_cx(k[17], k[32]); sort_cx(k[19], k[34]);
  sort_cx(k[21], k[36]); sort_cx(k[23], k[38]); sort_cx(k[25], k[40]); sort_cx(k[27], k[42]);
  sort_cx(k[29], k[44]); sort_cx(k[31], k[46]); sort_cx(k[33], k[48]); sort_cx(k[35], k[50]);
  sort_cx(k[37], k[52]); sort_cx(k[39], k[54]); sort_cx(k[41], k[56]); sort_cx(k[43], k[58]);
  sort_cx(k[45], k[60]); sort_cx(k[47], k[62]); sort_cx(k[1], k[8]); sort_cx(k[3], k[10]);
  sort_cx(k[5], k[12]); sort_cx(k[7], k[14]); sort_cx(k[9], k[16]); sort_cx(k[11], k[18]);
  sort_cx(k[13], k[20]); sort_cx(k[15], k[22]); sort_cx(k[17], k[24]); sort_cx(k[19], k[26]);
  sort_cx(k[21], k[28]); sort_cx(k[23], k[30]); sort_cx(k[25], k[32]); sort_cx(k[27], k[34]);
  sort_cx(k[29], k[36]); sort_cx(k[31], k[38]); sort_cx(k[33], k[40]); sort_cx(k[35], k[42]);
  sort_cx(k[37], k[44]); sort_cx(k[39], k[46]); sort_cx(k[41], k[48]); sort_cx(k[43], k[50]);
  sort_cx(k[45], k[52]); sort_cx(k[47], k[54]); sort_cx(k[49], k[56]); sort_cx(k[51], k[58]);
  sort_cx(k[53], k[60]); sort_cx(k[55], k[62]); sort_cx(k[1], k[4]); sort_cx(k[3], k[6]);
  sort_cx(k[5], k[8]); sort_cx(k[7], k[10]); sort_cx(k[9], k[12]); sort_cx(k[11], k[14]);
  sort_cx(k[13], k[16]); sort_cx(k[15], k[18]); sort_cx(k[17], k[20]); sort_cx(k[19], k[22]);
  sort_cx(k[21], k[24]); sort_cx(k[23], k[26]); sort_cx(k[25], k[28]); sort_cx(k[27], k[30]);
  sort_cx(k[29], k[32]); sort_cx(k[31], k[34]); sort_cx(k[33], k[36]); sort_cx(k[35], k[38]);
  sort_cx(k[37], k[40]); sort_cx(k[39], k[42]); sort_cx(k[41], k[44]); sort_cx(k[43], k[46]);
  sort_cx(k[45], k[48]); sort_cx(k[47], k[50]); sort_cx(k[49], k[52]); sort_cx(k[51], k[54]);
  sort_cx(k[53], k[56]); sort_cx(k[55], k[58]); sort_cx(k[57], k[60]); sort_cx(k[59], k[62]);
  sort_cx(k[1], k[2]); sort_cx(k[3], k[4]); sort_cx(k[5], k[6]); sort_cx(k[7], k[8]);
  sort_cx(k[9], k[10]); sort_cx(k[11], k[12]); sort_cx(k[13], k[14]); sort_cx(k[15], k[16]);
  sort_cx(k[17], k[18]); sort_cx(k[19], k[20]); sort_cx(k[21], k[22]); sort_cx(k[23], k[24]);
  sort_cx(k[25], k[26]); sort_cx(k[27], k[28]); sort_cx(k[29], k[30]); sort_cx(k[31], k[32]);
  sort_cx(k[33], k[34]); sort_cx(k[35], k[36]); sort_cx(k[37], k[38]); sort_cx(k[39], k[40]);
  sort_cx(k[41], k[42]); sort_cx(k[43], k[44]); sort_cx(k[45], k[46]); sort_cx(k[47], k[48]);
  sort_cx(k[49], k[50]); sort_cx(k[51], k[52]); sort_cx(k[53], k[54]); sort_cx(k[55], k[56]);
  sort_cx(k[57], k[58]); sort_cx(k[59], k[60]); sort_cx(k[61], k[62]);
}

// n = 128: 1471 comparators
__device__ __forceinline__ void sort_net(float (&k)[128]) {
  sort_cx(k[0], k[64]); sort_cx(k[1], k[65]); sort_cx(k[2], k[66]); sort_cx(k[3], k[67]);
  sort_cx(k[4], k[68]); sort_cx(k[5], k[69]); sort_cx(k[6], k[70]); sort_cx(k[7], k[71]);
  sort_cx(k[8], k[72]); sort_cx(k[9], k[73]); sort_cx(k[10], k[74]); sort_cx(k[11], k[75]);
  sort_cx(k[12], k[76]); sort_cx(k[13], k[77]); sort_cx(k[14], k[78]); sort_cx(k[15], k[79]);
  sort_cx(k[16], k[80]); sort_cx(k[17], k[81]); sort_cx(k[18], k[82]); sort_cx(k[19], k[83]);
  sort_cx(k[20], k[84]); sort_cx(k[21], k[85]); sort_cx(k[22], k[86]); sort_cx(k[23], k[87]);
  sort_cx(k[24], k[88]); sort_cx(k[25], k[89]); sort_cx(k[26], k[90]); sort_cx(k[27], k[91]);
  sort_cx(k[28], k[92]); sort_cx(k[29], k[93]); sort_cx(k[30], k[94]); sort_cx(k[31], k[95]);
  sort_cx(k[32], k[96]); sort_cx(k[33], k[97]); sort_cx(k[34], k[98]); sort_cx(k[35], k[99]);
  sort_cx(k[36], k[100]); sort_cx(k[37], k[101]); sort_cx(k[38], k[102]); sort_cx(k[39], k[103]);
  sort_cx(k[40], k[104]); sort_cx(k[41], k[105]); sort_cx(k[42], k[106]); sort_cx(k[43], k[107]);
  sort_cx(k[44], k[108]); sort_cx(k[45], k[109]); sort_cx(k[46], k[110]); sort_cx(k[47], k[111]);
  sort_cx(k[48], k[112]); sort_cx(k[49], k[113]); sort_cx(k[50], k[114]); sort_cx(k[51], k[115]);
  sort_cx(k[52], k[116]); sort_cx(k[53], k[117]); sort_cx(k[54], k[118]); sort_cx(k[55], k[119]);
  sort_cx(k[56], k[120]); sort_cx(k[57], k[121]); sort_cx(k[58], k[122]); sort_cx(k[59], k[123]);
  sort_cx(k[60], k[124]); sort_cx(k[61], k[125]); sort_cx(k[62], k[126]); sort_cx(k[63], k[127]);
  sort_cx(k[0], k[32]); sort_cx(k[1], k[33]); sort_cx(k[2], k[34]); sort_cx(k[3], k[35]);
  sort_cx(k[4], k[36]); sort_cx(k[5], k[37]); sort_cx(k[6], k[38]); sort_cx(k[7], k[39]);
  sort_cx(k[8], k[40]); sort_cx(k[9], k[41]); sort_cx(k[10], k[42]); sort_cx(k[11], k[43]);
  sort_cx(k[12], k[44]); sort_cx(k[13], k[45]); sort_cx(k[14], k[46]); sort_cx(k[15], k[47]);
  sort_cx(k[16], k[48]); sort_cx(k[17], k[49]); sort_cx(k[18], k[50]); sort_cx(k[19], k[51]);
  sort_cx(k[20], k[52]); sort_cx(k[21], k[53]); sort_cx(k[22], k[54]); sort_cx(k[23], k[55]);
  sort_cx(k[24], k[56]); sort_cx(k[25], k[57]); sort_cx(k[26], k[58]); sort_cx(k[27], k[59]);
  sort_cx(k[28], k[60]); sort_cx(k[29], k[61]); sort_cx(k[30], k[62]); sort_cx(k[31], k[63]);
  sort_cx(k[64], k[96]); sort_cx(k[65], k[97]); sort_cx(k[66], k[98]); sort_cx(k[67], k[99]);
  sort_cx(k[68], k[100]); sort_cx(k[69], k[101]); sort_cx(k[70], k[102]); sort_cx(k[71], k[103]);
  sort_cx(k[72], k[104]); sort_cx(k[73], k[105]); sort_cx(k[74], k[106]); sort_cx(k[75], k[107]);
  sort_cx(k[76], k[108]); sort_cx(k[77], k[109]); sort_cx(k[78], k[110]); sort_cx(k[79], k[111]);
  sort_cx(k[80], k[112]); sort_cx(k[81], k[113]); sort_cx(k[82], k[114]); sort_cx(k[83], k[115]);
  sort_cx(k[84], k[116]); sort_cx(k[85], k[117]); sort_cx(k[86], k[118]); sort_cx(k[87], k[119]);
  sort_cx(k[88], k[120]); sort_cx(k[89], k[121]); sort_cx(k[90], k[122]); sort_cx(k[91], k[123]);
  sort_cx(k[92], k[124]); sort_cx(k[93], k[125]); sort_cx(k[94], k[126]); sort_cx(k[95], k[127]);
  sort_cx(k[32], k[64]); sort_cx(k[33], k[65]); sort_cx(k[34], k[66]); sort_cx(k[35], k[67]);
  sort_cx(k[36], k[68]); sort_cx(k[37], k[69]); sort_cx(k[38], k[70]); sort_cx(k[39], k[71]);
  sort_cx(k[40], k[72]); sort_cx(k[41], k[73]); sort_cx(k[42], k[74]); sort_cx(k[43], k[75]);
  sort_cx(k[44], k[76]); sort_cx(k[45], k[77]); sort_cx(k[46], k[78]); sort_cx(k[47], k[79]);
  sort_cx(k[48], k[80]); sort_cx(k[49], k[81]); sort_cx(k[50], k[82]); sort_cx(k[51], k[83]);
  sort_cx(k[52], k[84]); sort_cx(k[53], k[85]); sort_cx(k[54], k[86]); sort_cx(k[55], k[87]);
  sort_cx(k[56], k[88]); sort_cx(k[57], k[89]); sort_cx(k[58], k[90]); sort_cx(k[59], k[91]);
  sort_cx(k[60], k[92]); sort_cx(k[61], k[93]); sort_cx(k[62], k[94]); sort_cx(k[63], k[95]);
  sort_cx(k[0], k[16]); sort_cx(k[1], k[17]); sort_cx(k[2], k[18]); sort_cx(k[3], k[19]);
  sort_cx(k[4], k[20]); sort_cx(k[5], k[21]); sort_cx(k[6], k[22]); sort_cx(k[7], k[23]);
  sort_cx(k[8], k[24]); sort_cx(k[9], k[25]); sort_cx(k[10], k[26]); sort_cx(k[11], k[27]);
  sort_cx(k[12], k[28]); sort_cx(k[13], k[29]); sort_cx(k[14], k[30]); sort_cx(k[15], k[31]);
  sort_cx(k[32], k[48]); sort_cx(k[33], k[49]); sort_cx(k[34], k[50]); sort_cx(k[35], k[51]);
  sort_cx(k[36], k[52]); sort_cx(k[37], k[53]); sort_cx(k[38], k[54]); sort_cx(k[39], k[55]);
  sort_cx(k[40], k[56]); sort_cx(k[41], k[57]); sort_cx(k[42], k[58]); sort_cx(k[43], k[59]);
  sort_cx(k[44], k[60]); sort_cx(k[45], k[61]); sort_cx(k[46], k[62]); sort_cx(k[47], k[63]);
  sort_cx(k[64], k[80]); sort_cx(k[65], k[81]); sort_cx(k[66], k[82]); sort_cx(k[67], k[83]);
  sort_cx(k[68], k[84]); sort_cx(k[69], k[85]); sort_cx(k[70], k[86]); sort_cx(k[71], k[87]);
  sort_cx(k[72], k[88]); sort_cx(k[73], k[89]); sort_cx(k[74], k[90]); sort_cx(k[75], k[91]);
  sort_cx(k[76], k[92]); sort_cx(k[77], k[93]); sort_cx(k[78], k[94]); sort_cx(k[79], k[95]);
  sort_cx(k[96], k[112]); sort_cx(k[97], k[113]); sort_cx(k[98], k[114]); sort_cx(k[99], k[115]);
  sort_cx(k[100], k[116]); sort_cx(k[101], k[117]); sort_cx(k[102], k[118]); sort_cx(k[103], k[119]);
  sort_cx(k[104], k[120]); sort_cx(k[105], k[121]); sort_cx(k[106], k[122]); sort_cx(k[107], k[123]);
  sort_cx(k[108], k[124]); sort_cx(k[109], k[125]); sort_cx(k[110], k[126]); sort_cx(k[111], k[127]);
  sort_cx(k[16], k[64]); sort_cx(k[17], k[65]); sort_cx(k[18], k[66]); sort_cx(k[19], k[67]);
  sort_cx(k[20], k[68]); sort_cx(k[21], k[69]); sort_cx(k[22], k[70]); sort_cx(k[23], k[71]);
  sort_cx(k[24], k[72]); sort_cx(k[25], k[73]); sort_cx(k[26], k[74]); sort_cx(k[27], k[75]);
  sort_cx(k[28], k[76]); sort_cx(k[29], k[77]); sort_cx(k[30], k[78]); sort_cx(k[31], k[79]);
  sort_cx(k[48], k[96]); sort_cx(k[49], k[97]); sort_cx(k[50], k[98]); sort_cx(k[51], k[99]);
  sort_cx(k[52], k[100]); sort_cx(k[53], k[101]); sort_cx(k[54], k[102]); sort_cx(k[55], k[103]);
  sort_cx(k[56], k[104]); sort_cx(k[57], k[105]); sort_cx(k[58], k[106]); sort_cx(k[59], k[107]);
  sort_cx(k[60], k[108]); sort_cx(k[61], k[109]); sort_cx(k[62], k[110]); sort_cx(k[63], k[111]);
  sort_cx(k[16], k[32]); sort_cx(k[17], k[33]); sort_cx(k[18], k[34]); sort_cx(k[19], k[35]);
  sort_cx(k[20], k[36]); sort_cx(k[21], k[37]); sort_cx(k[22], k[38]); sort_cx(k[23], k[39]);
  sort_cx(k[24], k[40]); sort_cx(k[25], k[41]); sort_cx(k[26], k[42]); sort_cx(k[27], k[43]);
  sort_cx(k[28], k[44]); sort_cx(k[29], k[45]); sort_cx(k[30], k[46]); sort_cx(k[31], k[47]);
  sort_cx(k[48], k[64]); sort_cx(k[49], k[65]); sort_cx(k[50], k[66]); sort_cx(k[51], k[67]);
  sort_cx(k[52], k[68]); sort_cx(k[53], k[69]); sort_cx(k[54], k[70]); sort_cx(k[55], k[71]);
  sort_cx(k[56], k[72]); sort_cx(k[57], k[73]); sort_cx(k[58], k[74]); sort_cx(k[59], k[75]);
  sort_cx(k[60], k[76]); sort_cx(k[61], k[77]); sort_cx(k[62], k[78]); sort_cx(k[63], k[79]);
  sort_cx(k[80], k[96]); sort_cx(k[81], k[97]); sort_cx(k[82], k[98]); sort_cx(k[83], k[99]);
  sort_cx(k[84], k[100]); sort_cx(k[85], k[101]); sort_cx(k[86], k[102]); sort_cx(k[87], k[103]);
  sort_cx(k[88], k[104]); sort_cx(k[89], k[105]); sort_cx(k[90], k[106]); sort_cx(k[91], k[107]);
  sort_cx(k[92], k[108]); sort_cx(k[93], k[109]); sort_cx(k[94], k[110]); sort_cx(k[95], k[111]);
  sort_cx(k[0], k[8]); sort_cx(k[1], k[9]); sort_cx(k[2], k[10]); sort_cx(k[3], k[11]);
  sort_cx(k[4], k[12]); sort_cx(k[5], k[13]); sort_cx(k[6], k[14]); sort_cx(k[7], k[15]);
  sort_cx(k[16], k[24]); sort_cx(k[17], k[25]); sort_cx(k[18], k[26]); sort_cx(k[19], k[27]);
  sort_cx(k[20], k[28]); sort_cx(k[21], k[29]); sort_cx(k[22], k[30]); sort_cx(k[23], k[31]);
  sort_cx(k[32], k[40]); sort_cx(k[33], k[41]); sort_cx(k[34], k[42]); sort_cx(k[35], k[43]);
  sort_cx(k[36], k[44]); sort_cx(k[37], k[45]); sort_cx(k[38], k[46]); sort_cx(k[39], k[47]);
  sort_cx(k[48], k[56]); sort_cx(k[49], k[57]); sort_cx(k[50], k[58]); sort_cx(k[51], k[59]);
  sort_cx(k[52], k[60]); sort_cx(k[53], k[61]); sort_cx(k[54], k[62]); sort_cx(k[55], k[63]);
  sort_cx(k[64], k[72]); sort_cx(k[65], k[73]); sort_cx(k[66], k[74]); sort_cx(k[67], k[75]);
  sort_cx(k[68], k[76]); sort_cx(k[69], k[77]); sort_cx(k[70], k[78]); sort_cx(k[71], k[79]);
  sort_cx(k[80], k[88]); sort_cx(k[81], k[89]); sort_cx(k[82], k[90]); sort_cx(k[83], k[91]);
  sort_cx(k[84], k[92]); sort_cx(k[85], k[93]); sort_cx(k[86], k[94]); sort_cx(k[87], k[95]);
  sort_cx(k[96], k[104]); sort_cx(k[97], k[105]); sort_cx(k[98], k[106]); sort_cx(k[99], k[107]);
  sort_cx(k[100], k[108]); sort_cx(k[101], k[109]); sort_cx(k[102], k[110]); sort_cx(k[103], k[111]);
  sort_cx(k[112], k[120]); sort_cx(k[113], k[121]); sort_cx(k[114], k[122]); sort_cx(k[115], k[123]);
  sort_cx(k[116], k[124]); sort_cx(k[117], k[125]); sort_cx(k[118], k[126]); sort_cx(k[119], k[127]);
  sort_cx(k[8], k[64]); sort_cx(k[9], k[65]); sort_cx(k[10], k[66]); sort_cx(k[11], k[67]);
  sort_cx(k[12], k[68]); sort_cx(k[13], k[69]); sort_cx(k[14], k[70]); sort_cx(k[15], k[71]);
  sort_cx(k[24], k[80]); sort_cx(k[25], k[81]); sort_cx(k[26], k[82]); sort_cx(k[27], k[83]);
  sort_cx(k[28], k[84]); sort_cx(k[29], k[85]); sort_cx(k[30], k[86]); sort_cx(k[31], k[87]);
  sort_cx(k[40], k[96]); sort_cx(k[41], k[97]); sort_cx(k[42], k[98]); sort_cx(k[43], k[99]);
  sort_cx(k[44], k[100]); sort_cx(k[45], k[101]); sort_cx(k[46], k[102]); sort_cx(k[47], k[103]);
  sort_cx(k[56], k[112]); sort_cx(k[57], k[113]); sort_cx(k[58], k[114]); sort_cx(k[59], k[115]);
  sort_cx(k[60], k[116]); sort_cx(k[61], k[117]); sort_cx(k[62], k[118]); sort_cx(k[63], k[119]);
  sort_cx(k[8], k[32]); sort_cx(k[9], k[33]); sort_cx(k[10], k[34]); sort_cx(k[11], k[35]);
  sort_cx(k[12], k[36]); sort_cx(k[13], k[37]); sort_cx(k[14], k[38]); sort_cx(k[15], k[39]);
  sort_cx(k[24], k[48]); sort_cx(k[25], k[49]); sort_cx(k[26], k[50]); sort_cx(k[27], k[51]);
  sort_cx(k[28], k[52]); sort_cx(k[29], k[53]); sort_cx(k[30], k[54]); sort_cx(k[31], k[55]);
  sort_cx(k[40], k[64]); sort_cx(k[41], k[65]); sort_cx(k[42], k[66]); sort_cx(k[43], k[67]);
  sort_cx(k[44], k[68]); sort_cx(k[45], k[69]); sort_cx(k[46], k[70]); sort_cx(k[47], k[71]);
  sort_cx(k[56], k[80]); sort_cx(k[57], k[81]); sort_cx(k[58], k[82]); sort_cx(k[59], k[83]);
  sort_cx(k[60], k[84]); sort_cx(k[61], k[85]); sort_cx(k[62], k[86]); sort_cx(k[63], k[87]);
  sort_cx(k[72], k[96]); sort_cx(k[73], k[97]); sort_cx(k[74], k[98]); sort_cx(k[75], k[99]);
  sort_cx(k[76], k[100]); sort_cx(k[77], k[101]); sort_cx(k[78], k[102]); sort_cx(k[79], k[103]);
  sort_cx(k[88], k[112]); sort_cx(k[89], k[113]); sort_cx(k[90], k[114]); sort_cx(k[91], k[115]);
  sort_cx(k[92], k[116]); sort_cx(k[93], k[117]); sort_cx(k[94], k[118]); sort_cx(k[95], k[119]);
  sort_cx(k[8], k[16]); sort_cx(k[9], k[17]); sort_cx(k[10], k[18]); sort_cx(k[11], k[19]);
  sort_cx(k[12], k[20]); sort_cx(k[13], k[21]); sort_cx(k[14], k[22]); sort_cx(k[15], k[23]);
  sort_cx(k[24], k[32]); sort_cx(k[25], k[33]); sort_cx(k[26], k[34]); sort_cx(k[27], k[35]);
  sort_cx(k[28], k[36]); sort_cx(k[29], k[37]); sort_cx(k[30], k[38]); sort_cx(k[31], k[39]);
  sort_cx(k[40], k[48]); sort_cx(k[41], k[49]); sort_cx(k[42], k[50]); sort_cx(k[43], k[51]);
  sort_cx(k[44], k[52]); sort_cx(k[45], k[53]); sort_cx(k[46], k[54]); sort_cx(k[47], k[55]);
  sort_cx(k[56], k[64]); sort_cx(k[57], k[65]); sort_cx(k[58], k[66]); sort_cx(k[59], k[67]);
  sort_cx(k[60], k[68]); sort_cx(k[61], k[69]); sort_cx(k[62], k[70]); sort_cx(k[63], k[71]);
  sort_cx(k[72], k[80]); sort_cx(k[73], k[81]); sort_cx(k[74], k[82]); sort_cx(k[75], k[83]);
  sort_cx(k[76], k[84]); sort_cx(k[77], k[85]); sort_cx(k[78], k[86]); sort_cx(k[79], k[87]);
  sort_cx(k[88], k[96]); sort_cx(k[89], k[97]); sort_cx(k[90], k[98]); sort_cx(k[91], k[99]);
  sort_cx(k[92], k[100]); sort_cx(k[93], k[101]); sort_cx(k[94], k[102]); sort_cx(k[95], k[103]);
  sort_cx(k[104], k[112]); sort_cx(k[105], k[113]); sort_cx(k[106], k[114]); sort_cx(k[107], k[115]);
  sort_cx(k[108], k[116]); sort_cx(k[109], k[117]); sort_cx(k[110], k[118]); sort_cx(k[111], k[119]);
  sort_cx(k[0], k[4]); sort_cx(k[1], k[5]); sort_cx(k[2], k[6]); sort_cx(k[3], k[7]);
  sort_cx(k[8], k[12]); sort_cx(k[9], k[13]); sort_cx(k[10], k[14]); sort_cx(k[11], k[15]);
  sort_cx(k[16], k[20]); sort_cx(k[17], k[21]); sort_cx(k[18], k[22]); sort_cx(k[19], k[23]);
  sort_cx(k[24], k[28]); sort_cx(k[25], k[29]); sort_cx(k[26], k[30]); sort_cx(k[27], k[31]);
  sort_cx(k[32], k[36]); sort_cx(k[33], k[37]); sort_cx(k[34], k[38]); sort_cx(k[35], k[39]);
  sort_cx(k[40], k[44]); sort_cx(k[41], k[45]); sort_cx(k[42], k[46]); sort_cx(k[43], k[47]);
  sort_cx(k[48], k[52]); sort_cx(k[49], k[53]); sort_cx(k[50], k[54]); sort_cx(k[51], k[55]);
  sort_cx(k[56], k[60]); sort_cx(k[57], k[61]); sort_cx(k[58], k[62]); sort_cx(k[59], k[63]);
  sort_cx(k[64], k[68]); sort_cx(k[65], k[69]); sort_cx(k[66], k[70]); sort_cx(k[67], k[71]);
  sort_cx(k[72], k[76]); sort_cx(k[73], k[77]); sort_cx(k[74], k[78]); sort_cx(k[75], k[79]);
  sort_cx(k[80], k[84]); sort_cx(k[81], k[85]); sort_cx(k[82], k[86]); sort_cx(k[83], k[87]);
  sort_cx(k[88], k[92]); sort_cx(k[89], k[93]); sort_cx(k[90], k[94]); sort_cx(k[91], k[95]);
  sort_cx(k[96], k[100]); sort_cx(k[97], k[101]); sort_cx(k[98], k[102]); sort_cx(k[99], k[103]);
  sort_cx(k[104], k[108]); sort_cx(k[105], k[109]); sort_cx(k[106], k[110]); sort_cx(k[107], k[111]);
  sort_cx(k[112], k[116]); sort_cx(k[113], k[117]); sort_cx(k[114], k[118]); sort_cx(k[115], k[119]);
  sort_cx(k[120], k[124]); sort_cx(k[121], k[125]); sort_cx(k[122], k[126]); sort_cx(k[123], k[127]);
  sort_cx(k[4], k[64]); sort_cx(k[5], k[65]); sort_cx(k[6], k[66]); sort_cx(k[7], k[67]);
  sort_cx(k[12], k[72]); sort_cx(k[13], k[73]); sort_cx(k[14], k[74]); sort_cx(k[15], k[75]);
  sort_cx(k[20], k[80]); sort_cx(k[21], k[81]); sort_cx(k[22], k[82]); sort_cx(k[23], k[83]);
  sort_cx(k[28], k[88]); sort_cx(k[29], k[89]); sort_cx(k[30], k[90]); sort_cx(k[31], k[91]);
  sort_cx(k[36], k[96]); sort_cx(k[37], k[97]); sort_cx(k[38], k[98]); sort_cx(k[39], k[99]);
  sort_cx(k[44], k[104]); sort_cx(k[45], k[105]); sort_cx(k[46], k[106]); sort_cx(k[47], k[107]);
  sort_cx(k[52], k[112]); sort_cx(k[53], k[113]); sort_cx(k[54], k[114]); sort_cx(k[55], k[115]);
  sort_cx(k[60], k[120]); sort_cx(k[61], k[121]); sort_cx(k[62], k[122]); sort_cx(k[63], k[123]);
  sort_cx(k[4], k[32]); sort_cx(k[5], k[33]); sort_cx(k[6], k[34]); sort_cx(k[7], k[35]);
  sort_cx(k[12], k[40]); sort_cx(k[13], k[41]); sort_cx(k[14], k[42]); sort_cx(k[15], k[43]);
  sort_cx(k[20], k[48]); sort_cx(k[21], k[49]); sort_cx(k[22], k[50]); sort_cx(k[23], k[51]);
  sort_cx(k[28], k[56]); sort_cx(k[29], k[57]); sort_cx(k[30], k[58]); sort_cx(k[31], k[59]);
  sort_cx(k[36], k[64]); sort_cx(k[37], k[65]); sort_cx(k[38], k[66]); sort_cx(k[39], k[67]);
  sort_cx(k[44], k[72]); sort_cx(k[45], k[73]); sort_cx(k[46], k[74]); sort_cx(k[47], k[75]);
  sort_cx(k[52], k[80]); sort_cx(k[53], k[81]); sort_cx(k[54], k[82]); sort_cx(k[55], k[83]);
  sort_cx(k[60], k[88]); sort_cx(k[61], k[89]); sort_cx(k[62], k[90]); sort_cx(k[63], k[91]);
  sort_cx(k[68], k[96]); sort_cx(k[69], k[97]); sort_cx(k[70], k[98]); sort_cx(k[71], k[99]);
  sort_cx(k[76], k[104]); sort_cx(k[77], k[105]); sort_cx(k[78], k[106]); sort_cx(k[79], k[107]);
  sort_cx(k[84], k[112]); sort_cx(k[85], k[113]); sort_cx(k[86], k[114]); sort_cx(k[87], k[115]);
  sort_cx(k[92], k[120]); sort_cx(k[93], k[121]); sort_cx(k[94], k[122]); sort_cx(k[95], k[123]);
  sort_cx(k[4], k[16]); sort_cx(k[5], k[17]); sort_cx(k[6], k[18]); sort_cx(k[7], k[19]);
  sort_cx(k[12], k[24]); sort_cx(k[13], k[25]); sort_cx(k[14], k[26]); sort_cx(k[15], k[27]);
  sort_cx(k[20], k[32]); sort_cx(k[21], k[33]); sort_cx(k[22], k[34]); sort_cx(k[23], k[35]);
  sort_cx(k[28], k[40]); sort_cx(k[29], k[41]); sort_cx(k[30], k[42]); sort_cx(k[31], k[43]);
  sort_cx(k[36], k[48]); sort_cx(k[37], k[49]); sort_cx(k[38], k[50]); sort_cx(k[39], k[51]);
  sort_cx(k[44], k[56]); sort_cx(k[45], k[57]); sort_cx(k[46], k[58]); sort_cx(k[47], k[59]);
  sort_cx(k[52], k[64]); sort_cx(k[53], k[65]); sort_cx(k[54], k[66]); sort_cx(k[55], k[67]);
  sort_cx(k[60], k[72]); sort_cx(k[61], k[73]); sort_cx(k[62], k[74]); sort_cx(k[63], k[75]);
  sort_cx(k[68], k[80]); sort_cx(k[69], k[81]); sort_cx(k[70], k[82]); sort_cx(k[71], k[83]);
  sort_cx(k[76], k[88]); sort_cx(k[77], k[89]); sort_cx(k[78], k[90]); sort_cx(k[79], k[91]);
  sort_cx(k[84], k[96]); sort_cx(k[85], k[97]); sort_cx(k[86], k[98]); sort_cx(k[87], k[99]);
  sort_cx(k[92], k[104]); sort_cx(k[93], k[105]); sort_cx(k[94], k[106]); sort_cx(k[95], k[107]);
  sort_cx(k[100], k[112]); sort_cx(k[101], k[113]); sort_cx(k[102], k[114]); sort_cx(k[103], k[115]);
  sort_cx(k[108], k[120]); sort_cx(k[109], k[121]); sort_cx(k[110], k[122]); sort_cx(k[111], k[123]);
  sort_cx(k[4], k[8]); sort_cx(k[5], k[9]); sort_cx(k[6], k[10]); sort_cx(k[7], k[11]);
  sort_cx(k[12], k[16]); sort_cx(k[13], k[17]); sort_cx(k[14], k[18]); sort_cx(k[15], k[19]);
  sort_cx(k[20], k[24]); sort_cx(k[21], k[25]); sort_cx(k[22], k[26]); sort_cx(k[23], k[27]);
  sort_cx(k[28], k[32]); sort_cx(k[29], k[33]); sort_cx(k[30], k[34]); sort_cx(k[31], k[35]);
  sort_cx(k[36], k[40]); sort_cx(k[37], k[41]); sort_cx(k[38], k[42]); sort_cx(k[39], k[43]);
  sort_cx(k[44], k[48]); sort_cx(k[45], k[49]); sort_cx(k[46], k[50]); sort_cx(k[47], k[51]);
  sort_cx(k[52], k[56]); sort_cx(k[53], k[57]); sort_cx(k[54], k[58]); sort_cx(k[55], k[59]);
  sort_cx(k[60], k[64]); sort_cx(k[61], k[65]); sort_cx(k[62], k[66]); sort_cx(k[63], k[67]);
  sort_cx(k[68], k[72]); sort_cx(k[69], k[73]); sort_cx(k[70], k[74]); sort_cx(k[71], k[75]);
  sort_cx(k[76], k[80]); sort_cx(k[77], k[81]); sort_cx(k[78], k[82]); sort_cx(k[79], k[83]);
  sort_cx(k[84], k[88]); sort_cx(k[85], k[89]); sort_cx(k[86], k[90]); sort_cx(k[87], k[91]);
  sort_cx(k[92], k[96]); sort_cx(k[93], k[97]); sort_cx(k[94], k[98]); sort_cx(k[95], k[99]);
  sort_cx(k[100], k[104]); sort_cx(k[101], k[105]); sort_cx(k[102], k[106]); sort_cx(k[103], k[107]);
  sort_cx(k[108], k[112]); sort_cx(k[109], k[113]); sort_cx(k[110], k[114]); sort_cx(k[111], k[115]);
  sort_cx(k[116], k[120]); sort_cx(k[117], k[121]); sort_cx(k[118], k[122]); sort_cx(k[119], k[123]);
  sort_cx(k[0], k[2]); sort_cx(k[1], k[3]); sort_cx(k[4], k[6]); sort_cx(k[5], k[7]);
  sort_cx(k[8], k[10]); sort_cx(k[9], k[11]); sort_cx(k[12], k[14]); sort_cx(k[13], k[15]);
  sort_cx(k[16], k[18]); sort_cx(k[17], k[19]); sort_cx(k[20], k[22]); sort_cx(k[21], k[23]);
  sort_cx(k[24], k[26]); sort_cx(k[25], k[27]); sort_cx(k[28], k[30]); sort_cx(k[29], k[31]);
  sort_cx(k[32], k[34]); sort_cx(k[33], k[35]); sort_cx(k[36], k[38]); sort_cx(k[37], k[39]);
  sort_cx(k[40], k[42]); sort_cx(k[41], k[43]); sort_cx(k[44], k[46]); sort_cx(k[45], k[47]);
  sort_cx(k[48], k[50]); sort_cx(k[49], k[51]); sort_cx(k[52], k[54]); sort_cx(k[53], k[55]);
  sort_cx(k[56], k[58]); sort_cx(k[57], k[59]); sort_cx(k[60], k[62]); sort_cx(k[61], k[63]);
  sort_cx(k[64], k[66]); sort_cx(k[65], k[67]); sort_cx(k[68], k[70]); sort_cx(k[69], k[71]);
  sort_cx(k[72], k[74]); sort_cx(k[73], k[75]); sort_cx(k[76], k[78]); sort_cx(k[77], k[79]);
  sort_cx(k[80], k[82]); sort_cx(k[81], k[83]); sort_cx(k[84], k[86]); sort_cx(k[85], k[87]);
  sort_cx(k[88], k[90]); sort_cx(k[89], k[91]); sort_cx(k[92], k[94]); sort_cx(k[93], k[95]);
  sort_cx(k[96], k[98]); sort_cx(k[97], k[99]); sort_cx(k[100], k[102]); sort_cx(k[101], k[103]);
  sort_cx(k[104], k[106]); sort_cx(k[105], k[107]); sort_cx(k[108], k[110]); sort_cx(k[109], k[111]);
  sort_cx(k[112], k[114]); sort_cx(k[113], k[115]); sort_cx(k[116], k[118]); sort_cx(k[117], k[119]);
  sort_cx(k[120], k[122]); sort_cx(k[121], k[123]); sort_cx(k[124], k[126]); sort_cx(k[125], k[127]);
  sort_cx(k[2], k[64]); sort_cx(k[3], k[65]); sort_cx(k[6], k[68]); sort_cx(k[7], k[69]);
  sort_cx(k[10], k[72]); sort_cx(k[11], k[73]); sort_cx(k[14], k[76]); sort_cx(k[15], k[77]);
  sort_cx(k[18], k[80]); sort_cx(k[19], k[81]); sort_cx(k[22], k[84]); sort_cx(k[23], k[85]);
  sort_cx(k[26], k[88]); sort_cx(k[27], k[89]); sort_cx(k[30], k[92]); sort_cx(k[31], k[93]);
  sort_cx(k[34], k[96]); sort_cx(k[35], k[97]); sort_cx(k[38], k[100]); sort_cx(k[39], k[101]);
  sort_cx(k[42], k[104]); sort_cx(k[43], k[105]); sort_cx(k[46], k[108]); sort_cx(k[47], k[109]);
  sort_cx(k[50], k[112]); sort_cx(k[51], k[113]); sort_cx(k[54], k[116]); sort_cx(k[55], k[117]);
  sort_cx(k[58], k[120]); sort_cx(k[59], k[121]); sort_cx(k[62], k[124]); sort_cx(k[63], k[125]);
  sort_cx(k[2], k[32]); sort_cx(k[3], k[33]); sort_cx(k[6], k[36]); sort_cx(k[7], k[37]);
  sort_cx(k[10], k[40]); sort_cx(k[11], k[41]); sort_cx(k[14], k[44]); sort_cx(k[15], k[45]);
  sort_cx(k[18], k[48]); sort_cx(k[19], k[49]); sort_cx(k[22], k[52]); sort_cx(k[23], k[53]);
  sort_cx(k[26], k[56]); sort_cx(k[27], k[57]); sort_cx(k[30], k[60]); sort_cx(k[31], k[61]);
  sort_cx(k[34], k[64]); sort_cx(k[35], k[65]); sort_cx(k[38], k[68]); sort_cx(k[39], k[69]);
  sort_cx(k[42], k[72]); sort_cx(k[43], k[73]); sort_cx(k[46], k[76]); sort_cx(k[47], k[77]);
  sort_cx(k[50], k[80]); sort_cx(k[51], k[81]); sort_cx(k[54], k[84]); sort_cx(k[55], k[85]);
  sort_cx(k[58], k[88]); sort_cx(k[59], k[89]); sort_cx(k[62], k[92]); sort_cx(k[63], k[93]);
  sort_cx(k[66], k[96]); sort_cx(k[67], k[97]); sort_cx(k[70], k[100]); sort_cx(k[71], k[101]);
  sort_cx(k[74], k[104]); sort_cx(k[75], k[105]); sort_cx(k[78], k[108]); sort_cx(k[79], k[109]);
  sort_cx(k[82], k[112]); sort_cx(k[83], k[113]); sort_cx(k[86], k[116]); sort_cx(k[87], k[117]);
  sort_cx(k[90], k[120]); sort_cx(k[91], k[121]); sort_cx(k[94], k[124]); sort_cx(k[95], k[125]);
  sort_cx(k[2], k[16]); sort_cx(k[3], k[17]); sort_cx(k[6], k[20]); sort_cx(k[7], k[21]);
  sort_cx(k[10], k[24]); sort_cx(k[11], k[25]); sort_cx(k[14], k[28]); sort_cx(k[15], k[29]);
  sort_cx(k[18], k[32]); sort_cx(k[19], k[33]); sort_cx(k[22], k[36]); sort_cx(k[23], k[37]);
  sort_cx(k[26], k[40]); sort_cx(k[27], k[41]); sort_cx(k[30], k[44]); sort_cx(k[31], k[45]);
  sort_cx(k[34], k[48]); sort_cx(k[35], k[49]); sort_cx(k[38], k[52]); sort_cx(k[39], k[53]);
  sort_cx(k[42], k[56]); sort_cx(k[43], k[57]); sort_cx(k[46], k[60]); sort_cx(k[47], k[61]);
  sort_cx(k[50], k[64]); sort_cx(k[51], k[65]); sort_cx(k[54], k[68]); sort_cx(k[55], k[69]);
  sort_cx(k[58], k[72]); sort_cx(k[59], k[73]); sort_cx(k[62], k[76]); sort_cx(k[63], k[77]);
  sort_cx(k[66], k[80]); sort_cx(k[67], k[81]); sort_cx(k[70], k[84]); sort_cx(k[71], k[85]);
  sort_cx(k[74], k[88]); sort_cx(k[75], k[89]); sort_cx(k[78], k[92]); sort_cx(k[79], k[93]);
  sort_cx(k[82], k[96]); sort_cx(k[83], k[97]); sort_cx(k[86], k[100]); sort_cx(k[87], k[101]);
  sort_cx(k[90], k[104]); sort_cx(k[91], k[105]); sort_cx(k[94], k[108]); sort_cx(k[95], k[109]);
  sort_cx(k[98], k[112]); sort_cx(k[99], k[113]); sort_cx(k[102], k[116]); sort_cx(k[103], k[117]);
  sort_cx(k[106], k[120]); sort_cx(k[107], k[121]); sort_cx(k[110], k[124]); sort_cx(k[111], k[125]);
  sort_cx(k[2], k[8]); sort_cx(k[3], k[9]); sort_cx(k[6], k[12]); sort_cx(k[7], k[13]);
  sort_cx(k[10], k[16]); sort_cx(k[11], k[17]); sort_cx(k[14], k[20]); sort_cx(k[15], k[21]);
  sort_cx(k[18], k[24]); sort_cx(k[19], k[25]); sort_cx(k[22], k[28]); sort_cx(k[23], k[29]);
  sort_cx(k[26], k[32]); sort_cx(k[27], k[33]); sort_cx(k[30], k[36]); sort_cx(k[31], k[37]);
  sort_cx(k[34], k[40]); sort_cx(k[35], k[41]); sort_cx(k[38], k[44]); sort_cx(k[39], k[45]);
  sort_cx(k[42], k[48]); sort_cx(k[43], k[49]); sort_cx(k[46], k[52]); sort_cx(k[47], k[53]);
  sort_cx(k[50], k[56]); sort_cx(k[51], k[57]); sort_cx(k[54], k[60]); sort_cx(k[55], k[61]);
  sort_cx(k[58], k[64]); sort_cx(k[59], k[65]); sort_cx(k[62], k[68]); sort_cx(k[63], k[69]);
  sort_cx(k[66], k[72]); sort_cx(k[67], k[73]); sort_cx(k[70], k[76]); sort_cx(k[71], k[77]);
  sort_cx(k[74], k[80]); sort_cx(k[75], k[81]); sort_cx(k[78], k[84]); sort_cx(k[79], k[85]);
  sort_cx(k[82], k[88]); sort_cx(k[83], k[89]); sort_cx(k[86], k[92]); sort_cx(k[87], k[93]);
  sort_cx(k[90], k[96]); sort_cx(k[91], k[97]); sort_cx(k[94], k[100]); sort_cx(k[95], k[101]);
  sort_cx(k[98], k[104]); sort_cx(k[99], k[105]); sort_cx(k[102], k[108]); sort_cx(k[103], k[109]);
  sort_cx(k[106], k[112]); sort_cx(k[107], k[113]); sort_cx(k[110], k[116]); sort_cx(k[111], k[117]);
  sort_cx(k[114], k[120]); sort_cx(k[115], k[121]); sort_cx(k[118], k[124]); sort_cx(k[119], k[125]);
  sort_cx(k[2], k[4]); sort_cx(k[3], k[5]); sort_cx(k[6], k[8]); sort_cx(k[7], k[9]);
  sort_cx(k[10], k[12]); sort_cx(k[11], k[13]); sort_cx(k[14], k[16]); sort_cx(k[15], k[17]);
  sort_cx(k[18], k[20]); sort_cx(k[19], k[21]); sort_cx(k[22], k[24]); sort_cx(k[23], k[25]);
  sort_cx(k[26], k[28]); sort_cx(k[27], k[29]); sort_cx(k[30], k[32]); sort_cx(k[31], k[33]);
  sort_cx(k[34], k[36]); sort_cx(k[35], k[37]); sort_cx(k[38], k[40]); sort_cx(k[39], k[41]);
  sort_cx(k[42], k[44]); sort_cx(k[43], k[45]); sort_cx(k[46], k[48]); sort_cx(k[47], k[49]);
  sort_cx(k[50], k[52]); sort_cx(k[51], k[53]); sort_cx(k[54], k[56]); sort_cx(k[55], k[57]);
  sort_cx(k[58], k[60]); sort_cx(k[59], k[61]); sort_cx(k[62], k[64]); sort_cx(k[63], k[65]);
  sort_cx(k[66], k[68]); sort_cx(k[67], k[69]); sort_cx(k[70], k[72]); sort_cx(k[71], k[73]);
  sort_cx(k[74], k[76]); sort_cx(k[75], k[77]); sort_cx(k[78], k[80]); sort_cx(k[79], k[81]);
  sort_cx(k[82], k[84]); sort_cx(k[83], k[85]); sort_cx(k[86], k[88]); sort_cx(k[87], k[89]);
  sort_cx(k[90], k[92]); sort_cx(k[91], k[93]); sort_cx(k[94], k[96]); sort_cx(k[95], k[97]);
  sort_cx(k[98], k[100]); sort_cx(k[99], k[101]); sort_cx(k[102], k[104]); sort_cx(k[103], k[105]);
  sort_cx(k[106], k[108]); sort_cx(k[107], k[109]); sort_cx(k[110], k[112]); sort_cx(k[111], k[113]);
  sort_cx(k[114], k[116]); sort_cx(k[115], k[117]); sort_cx(k[118], k[120]); sort_cx(k[119], k[121]);
  sort_cx(k[122], k[124]); sort_cx(k[123], k[125]); sort_cx(k[0], k[1]); sort_cx(k[2], k[3]);
  sort_cx(k[4], k[5]); sort_cx(k[6], k[7]); sort_cx(k[8], k[9]); sort_cx(k[10], k[11]);
  sort_cx(k[12], k[13]); sort_cx(k[14], k[15]); sort_cx(k[16], k[17]); sort_cx(k[18], k[19]);
  sort_cx(k[20], k[21]); sort_cx(k[22], k[23]); sort_cx(k[24], k[25]); sort_cx(k[26], k[27]);
  sort_cx(k[28], k[29]); sort_cx(k[30], k[31]); sort_cx(k[32], k[33]); sort_cx(k[34], k[35]);
  sort_cx(k[36], k[37]); sort_cx(k[38], k[39]); sort_cx(k[40], k[41]); sort_cx(k[42], k[43]);
  sort_cx(k[44], k[45]); sort_cx(k[46], k[47]); sort_cx(k[48], k[49]); sort_cx(k[50], k[51]);
  sort_cx(k[52], k[53]); sort_cx(k[54], k[55]); sort_cx(k[56], k[57]); sort_cx(k[58], k[59]);
  sort_cx(k[60], k[61]); sort_cx(k[62], k[63]); sort_cx(k[64], k[65]); sort_cx(k[66], k[67]);
  sort_cx(k[68], k[69]); sort_cx(k[70], k[71]); sort_cx(k[72], k[73]); sort_cx(k[74], k[75]);
  sort_cx(k[76], k[77]); sort_cx(k[78], k[79]); sort_cx(k[80], k[81]); sort_cx(k[82], k[83]);
  sort_cx(k[84], k[85]); sort_cx(k[86], k[87]); sort_cx(k[88], k[89]); sort_cx(k[90], k[91]);
  sort_cx(k[92], k[93]); sort_cx(k[94], k[95]); sort_cx(k[96], k[97]); sort_cx(k[98], k[99]);
  sort_cx(k[100], k[101]); sort_cx(k[102], k[103]); sort_cx(k[104], k[105]); sort_cx(k[106], k[107]);
  sort_cx(k[108], k[109]); sort_cx(k[110], k[111]); sort_cx(k[112], k[113]); sort_cx(k[114], k[115]);
  sort_cx(k[116], k[117]); sort_cx(k[118], k[119]); sort_cx(k[120], k[121]); sort_cx(k[122], k[123]);
  sort_cx(k[124], k[125]); sort_cx(k[126], k[127]); sort_cx(k[1], k[64]); sort_cx(k[3], k[66]);
  sort_cx(k[5], k[68]); sort_cx(k[7], k[70]); sort_cx(k[9], k[72]); sort_cx(k[11], k[74]);
  sort_cx(k[13], k[76]); sort_cx(k[15], k[78]); sort_cx(k[17], k[80]); sort_cx(k[19], k[82]);
  sort_cx(k[21], k[84]); sort_cx(k[23], k[86]); sort_cx(k[25], k[88]); sort_cx(k[27], k[90]);
  sort_cx(k[29], k[92]); sort_cx(k[31], k[94]); sort_cx(k[33], k[96]); sort_cx(k[35], k[98]);
  sort_cx(k[37], k[100]); sort_cx(k[39], k[102]); sort_cx(k[41], k[104]); sort_cx(k[43], k[106]);
  sort_cx(k[45], k[108]); sort_cx(k[47], k[110]); sort_cx(k[49], k[112]); sort_cx(k[51], k[114]);
  sort_cx(k[53], k[116]); sort_cx(k[55], k[118]); sort_cx(k[57], k[120]); sort_cx(k[59], k[122]);
  sort_cx(k[61], k[124]); sort_cx(k[63], k[126]); sort_cx(k[1], k[32]); sort_cx(k[3], k[34]);
  sort_cx(k[5], k[36]); sort_cx(k[7], k[38]); sort_cx(k[9], k[40]); sort_cx(k[11], k[42]);
  sort_cx(k[13], k[44]); sort_cx(k[15], k[46]); sort_cx(k[17], k[48]); sort_cx(k[19], k[50]);
  sort_cx(k[21], k[52]); sort_cx(k[23], k[54]); sort_cx(k[25], k[56]); sort_cx(k[27], k[58]);
  sort_cx(k[29], k[60]); sort_cx(k[31], k[62]); sort_cx(k[33], k[64]); sort_cx(k[35], k[66]);
  sort_cx(k[37], k[68]); sort_cx(k[39], k[70]); sort_cx(k[41], k[72]); sort_cx(k[43], k[74]);
  sort_cx(k[45], k[76]); sort_cx(k[47], k[78]); sort_cx(k[49], k[80]); sort_cx(k[51], k[82]);
  sort_cx(k[53], k[84]); sort_cx(k[55], k[86]); sort_cx(k[57], k[88]); sort_cx(k[59], k[90]);
  sort_cx(k[61], k[92]); sort_cx(k[63], k[94]); sort_cx(k[65], k[96]); sort_cx(k[67], k[98]);
  sort_cx(k[69], k[100]); sort_cx(k[71], k[102]); sort_cx(k[73], k[104]); sort_cx(k[75], k[106]);
  sort_cx(k[77], k[108]); sort_cx(k[79], k[110]); sort_cx(k[81], k[112]); sort_cx(k[83], k[114]);
  sort_cx(k[85], k[116]); sort_cx(k[87], k[118]); sort_cx(k[89], k[120]); sort_cx(k[91], k[122]);
  sort_cx(k[93], k[124]); sort_cx(k[95], k[126]); sort_cx(k[1], k[16]); sort_cx(k[3], k[18]);
  sort_cx(k[5], k[20]); sort_cx(k[7], k[22]); sort_cx(k[9], k[24]); sort_cx(k[11], k[26]);
  sort_cx(k[13], k[28]); sort_cx(k[15], k[30]); sort_cx(k[17], k[32]); sort_cx(k[19], k[34]);
  sort_cx(k[21], k[36]); sort_cx(k[23], k[38]); sort_cx(k[25], k[40]); sort_cx(k[27], k[42]);
  sort_cx(k[29], k[44]); sort_cx(k[31], k[46]); sort_cx(k[33], k[48]); sort_cx(k[35], k[50]);
  sort_cx(k[37], k[52]); sort_cx(k[39], k[54]); sort_cx(k[41], k[56]); sort_cx(k[43], k[58]);
  sort_cx(k[45], k[60]); sort_cx(k[47], k[62]); sort_cx(k[49], k[64]); sort_cx(k[51], k[66]);
  sort_cx(k[53], k[68]); sort_cx(k[55], k[70]); sort_cx(k[57], k[72]); sort_cx(k[59], k[74]);
  sort_cx(k[61], k[76]); sort_cx(k[63], k[78]); sort_cx(k[65], k[80]); sort_cx(k[67], k[82]);
  sort_cx(k[69], k[84]); sort_cx(k[71], k[86]); sort_cx(k[73], k[88]); sort_cx(k[75], k[90]);
  sort_cx(k[77], k[92]); sort_cx(k[79], k[94]); sort_cx(k[81], k[96]); sort_cx(k[83], k[98]);
  sort_cx(k[85], k[100]); sort_cx(k[87], k[102]); sort_cx(k[89], k[104]); sort_cx(k[91], k[106]);
  sort_cx(k[93], k[108]); sort_cx(k[95], k[110]); sort_cx(k[97], k[112]); sort_cx(k[99], k[114]);
  sort_cx(k[101], k[116]); sort_cx(k[103], k[118]); sort_cx(k[105], k[120]); sort_cx(k[107], k[122]);
  sort_cx(k[109], k[124]); sort_cx(k[111], k[126]); sort_cx(k[1], k[8]); sort_cx(k[3], k[10]);
  sort_cx(k[5], k[12]); sort_cx(k[7], k[14]); sort_cx(k[9], k[16]); sort_cx(k[11], k[18]);
  sort_cx(k[13], k[20]); sort_cx(k[15], k[22]); sort_cx(k[17], k[24]); sort_cx(k[19], k[26]);
  sort_cx(k[21], k[28]); sort_cx(k[23], k[30]); sort_cx(k[25], k[32]); sort_cx(k[27], k[34]);
  sort_cx(k[29], k[36]); sort_cx(k[31], k[38]); sort_cx(k[33], k[40]); sort_cx(k[35], k[42]);
  sort_cx(k[37], k[44]); sort_cx(k[39], k[46]); sort_cx(k[41], k[48]); sort_cx(k[43], k[50]);
  sort_cx(k[45], k[52]); sort_cx(k[47], k[54]); sort_cx(k[49], k[56]); sort_cx(k[51], k[58]);
  sort_cx(k[53], k[60]); sort_cx(k[55], k[62]); sort_cx(k[57], k[64]); sort_cx(k[59], k[66]);
  sort_cx(k[61], k[68]); sort_cx(k[63], k[70]); sort_cx(k[65], k[72]); sort_cx(k[67], k[74]);
  sort_cx(k[69], k[76]); sort_cx(k[71], k[78]); sort_cx(k[73], k[80]); sort_cx(k[75], k[82]);
  sort_cx(k[77], k[84]); sort_cx(k[79], k[86]); sort_cx(k[81], k[88]); sort_cx(k[83], k[90]);
  sort_cx(k[85], k[92]); sort_cx(k[87], k[94]); sort_cx(k[89], k[96]); sort_cx(k[91], k[98]);
  sort_cx(k[93], k[100]); sort_cx(k[95], k[102]); sort_cx(k[97], k[104]); sort_cx(k[99], k[106]);
  sort_cx(k[101], k[108]); sort_cx(k[103], k[110]); sort_cx(k[105], k[112]); sort_cx(k[107], k[114]);
  sort_cx(k[109], k[116]); sort_cx(k[111], k[118]); sort_cx(k[113], k[120]); sort_cx(k[115], k[122]);
  sort_cx(k[117], k[124]); sort_cx(k[119], k[126]); sort_cx(k[1], k[4]); sort_cx(k[3], k[6]);
  sort_cx(k[5], k[8]); sort_cx(k[7], k[10]); sort_cx(k[9], k[12]); sort_cx(k[11], k[14]);
  sort_cx(k[13], k[16]); sort_cx(k[15], k[18]); sort_cx(k[17], k[20]); sort_cx(k[19], k[22]);
  sort_cx(k[21], k[24]); sort_cx(k[23], k[26]); sort_cx(k[25], k[28]); sort_cx(k[27], k[30]);
  sort_cx(k[29], k[32]); sort_cx(k[31], k[34]); sort_cx(k[33], k[36]); sort_cx(k[35], k[38]);
  sort_cx(k[37], k[40]); sort_cx(k[39], k[42]); sort_cx(k[41], k[44]); sort_cx(k[43], k[46]);
  sort_cx(k[45], k[48]); sort_cx(k[47], k[50]); sort_cx(k[49], k[52]); sort_cx(k[51], k[54]);
  sort_cx(k[53], k[56]); sort_cx(k[55], k[58]); sort_cx(k[57], k[60]); sort_cx(k[59], k[62]);
  sort_cx(k[61], k[64]); sort_cx(k[63], k[66]); sort_cx(k[65], k[68]); sort_cx(k[67], k[70]);
  sort_cx(k[69], k[72]); sort_cx(k[71], k[74]); sort_cx(k[73], k[76]); sort_cx(k[75], k[78]);
  sort_cx(k[77], k[80]); sort_cx(k[79], k[82]); sort_cx(k[81], k[84]); sort_cx(k[83], k[86]);
  sort_cx(k[85], k[88]); sort_cx(k[87], k[90]); sort_cx(k[89], k[92]); sort_cx(k[91], k[94]);
  sort_cx(k[93], k[96]); sort_cx(k[95], k[98]); sort_cx(k[97], k[100]); sort_cx(k[99], k[102]);
  sort_cx(k[101], k[104]); sort_cx(k[103], k[106]); sort_cx(k[105], k[108]); sort_cx(k[107], k[110]);
  sort_cx(k[109], k[112]); sort_cx(k[111], k[114]); sort_cx(k[113], k[116]); sort_cx(k[115], k[118]);
  sort_cx(k[117], k[120]); sort_cx(k[119], k[122]); sort_cx(k[121], k[124]); sort_cx(k[123], k[126]);
  sort_cx(k[1], k[2]); sort_cx(k[3], k[4]); sort_cx(k[5], k[6]); sort_cx(k[7], k[8]);
  sort_cx(k[9], k[10]); sort_cx(k[11], k[12]); sort_cx(k[13], k[14]); sort_cx(k[15], k[16]);
  sort_cx(k[17], k[18]); sort_cx(k[19], k[20]); sort_cx(k[21], k[22]); sort_cx(k[23], k[24]);
  sort_cx(k[25], k[26]); sort_cx(k[27], k[28]); sort_cx(k[29], k[30]); sort_cx(k[31], k[32]);
  sort_cx(k[33], k[34]); sort_cx(k[35], k[36]); sort_cx(k[37], k[38]); sort_cx(k[39], k[40]);
  sort_cx(k[41], k[42]); sort_cx(k[43], k[44]); sort_cx(k[45], k[46]); sort_cx(k[47], k[48]);
  sort_cx(k[49], k[50]); sort_cx(k[51], k[52]); sort_cx(k[53], k[54]); sort_cx(k[55], k[56]);
  sort_cx(k[57], k[58]); sort_cx(k[59], k[60]); sort_cx(k[61], k[62]); sort_cx(k[63], k[64]);
  sort_cx(k[65], k[66]); sort_cx(k[67], k[68]); sort_cx(k[69], k[70]); sort_cx(k[71], k[72]);
  sort_cx(k[73], k[74]); sort_cx(k[75], k[76]); sort_cx(k[77], k[78]); sort_cx(k[79], k[80]);
  sort_cx(k[81], k[82]); sort_cx(k[83], k[84]); sort_cx(k[85], k[86]); sort_cx(k[87], k[88]);
  sort_cx(k[89], k[90]); sort_cx(k[91], k[92]); sort_cx(k[93], k[94]); sort_cx(k[95], k[96]);
  sort_cx(k[97], k[98]); sort_cx(k[99], k[100]); sort_cx(k[101], k[102]); sort_cx(k[103], k[104]);
  sort_cx(k[105], k[106]); sort_cx(k[107], k[108]); sort_cx(k[109], k[110]); sort_cx(k[111], k[112]);
  sort_cx(k[113], k[114]); sort_cx(k[115], k[116]); sort_cx(k[117], k[118]); sort_cx(k[119], k[120]);
  sort_cx(k[121], k[122]); sort_cx(k[123], k[124]); sort_cx(k[125], k[126]);
}
