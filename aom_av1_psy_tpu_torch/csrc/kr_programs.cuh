// Generated by tools/gen_kr_programs.py from
// normative/data/txfm_stages.json and ops/txfm_host's tables; do not edit.
// Regenerate: python3 tools/gen_kr_programs.py
//
// Kernel KR's 1-D stage programs as straight-line code over an int array
// with compile-time indices (registers): a stage's pass-through is a
// rename, +-1 entries an add or a subtract, a butterfly two products,
// the rounding add and the shift; the stage clamp where the entry
// carries it and CLAMP is set. int32 wraparound as the reference's.
#pragma once

#include "txfm.cuh"

// cospi[i] at cos bit cb (10..13), sinpi[i] (i < 5)
__host__ __device__ constexpr int kr_cospi(int cb, int i) {
  constexpr int t[4][64] = {
      {1024, 1024, 1023, 1021, 1019, 1016, 1013, 1009, 1004, 999, 993, 987,
       980, 972, 964, 955, 946, 936, 926, 915, 903, 891, 878, 865, 851, 837,
       822, 807, 792, 775, 759, 742, 724, 706, 688, 669, 650, 630, 610, 590,
       569, 548, 526, 505, 483, 460, 438, 415, 392, 369, 345, 321, 297, 273,
       249, 224, 200, 175, 150, 125, 100, 75, 50, 25},
      {2048, 2047, 2046, 2042, 2038, 2033, 2026, 2018, 2009, 1998, 1987,
       1974, 1960, 1945, 1928, 1911, 1892, 1872, 1851, 1829, 1806, 1782,
       1757, 1730, 1703, 1674, 1645, 1615, 1583, 1551, 1517, 1483, 1448,
       1412, 1375, 1338, 1299, 1260, 1220, 1179, 1138, 1096, 1053, 1009, 965,
       921, 876, 830, 784, 737, 690, 642, 595, 546, 498, 449, 400, 350, 301,
       251, 201, 151, 100, 50},
      {4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973,
       3948, 3920, 3889, 3857, 3822, 3784, 3745, 3703, 3659, 3612, 3564,
       3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896,
       2824, 2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019,
       1931, 1842, 1751, 1660, 1567, 1474, 1380, 1285, 1189, 1092, 995, 897,
       799, 700, 601, 501, 401, 301, 201, 101},
      {8192, 8190, 8182, 8170, 8153, 8130, 8103, 8071, 8035, 7993, 7946,
       7895, 7839, 7779, 7713, 7643, 7568, 7489, 7405, 7317, 7225, 7128,
       7027, 6921, 6811, 6698, 6580, 6458, 6333, 6203, 6070, 5933, 5793,
       5649, 5501, 5351, 5197, 5040, 4880, 4717, 4551, 4383, 4212, 4038,
       3862, 3683, 3503, 3320, 3135, 2948, 2760, 2570, 2378, 2185, 1990,
       1795, 1598, 1401, 1202, 1003, 803, 603, 402, 201},
  };
  return t[cb - 10][i];
}

__host__ __device__ constexpr int kr_sinpi(int cb, int i) {
  constexpr int t[4][5] = {
      {0, 330, 621, 836, 951},
      {0, 660, 1241, 1672, 1901},
      {0, 1321, 2482, 3344, 3803},
      {0, 2642, 4964, 6689, 7606},
  };
  return t[cb - 10][i];
}

template <bool CLAMP>
__device__ __forceinline__ int kr_clamp(int v, int lo, int hi) {
  return CLAMP ? clampi(v, lo, hi) : v;
}

template <int CB, int WA, int WB>
__device__ __forceinline__ int kr_btf(int a, int b) {
  return add32(add32(mul32(a, WA), mul32(b, WB)), 1 << (CB - 1)) >> CB;
}

// The plan of each tx size (tools/gen_kr_programs.plan): W, H; HR the
// row pass's vectors a block and CW the inverse's coded columns; the
// two passes' cos bits; the shifts (forward three, inverse two);
// RECT the NewSqrt2 rescale; G blocks and T threads a CTA; tile A
// ([r][c]) row and block strides RA, BA, tile B ([c][r]) RB, BB (words).
template <int TS, bool INV>
struct KrPlan;
template <>
struct KrPlan<0, false> {
  static constexpr int W = 4, H = 4, HR = 4, CW = 4, CB1 = 13, CB2 = 13,
                       SH0 = 2, SH1 = 0, SH2 = 0, RECT = 0, G = 32, T = 128,
                       RA = 4, BA = 36, RB = 4, BB = 36;
};
template <>
struct KrPlan<1, false> {
  static constexpr int W = 8, H = 8, HR = 8, CW = 8, CB1 = 13, CB2 = 13,
                       SH0 = 2, SH1 = -1, SH2 = 0, RECT = 0, G = 16, T = 128,
                       RA = 12, BA = 104, RB = 12, BB = 104;
};
template <>
struct KrPlan<2, false> {
  static constexpr int W = 16, H = 16, HR = 16, CW = 16, CB1 = 13, CB2 = 12,
                       SH0 = 2, SH1 = -2, SH2 = 0, RECT = 0, G = 8, T = 128,
                       RA = 20, BA = 336, RB = 20, BB = 336;
};
template <>
struct KrPlan<3, false> {
  static constexpr int W = 32, H = 32, HR = 32, CW = 32, CB1 = 12, CB2 = 12,
                       SH0 = 2, SH1 = -4, SH2 = 0, RECT = 0, G = 4, T = 128,
                       RA = 36, BA = 1152, RB = 36, BB = 1152;
};
template <>
struct KrPlan<4, false> {
  static constexpr int W = 64, H = 64, HR = 64, CW = 64, CB1 = 13, CB2 = 10,
                       SH0 = 0, SH1 = -2, SH2 = -2, RECT = 0, G = 1, T = 64,
                       RA = 68, BA = 4352, RB = 68, BB = 4352;
};
template <>
struct KrPlan<5, false> {
  static constexpr int W = 4, H = 8, HR = 8, CW = 4, CB1 = 13, CB2 = 13,
                       SH0 = 2, SH1 = -1, SH2 = 0, RECT = 1, G = 32, T = 128,
                       RA = 4, BA = 36, RB = 12, BB = 72;
};
template <>
struct KrPlan<6, false> {
  static constexpr int W = 8, H = 4, HR = 4, CW = 8, CB1 = 13, CB2 = 13,
                       SH0 = 2, SH1 = -1, SH2 = 0, RECT = 1, G = 32, T = 128,
                       RA = 12, BA = 72, RB = 4, BB = 36;
};
template <>
struct KrPlan<7, false> {
  static constexpr int W = 8, H = 16, HR = 16, CW = 8, CB1 = 13, CB2 = 13,
                       SH0 = 2, SH1 = -2, SH2 = 0, RECT = 1, G = 16, T = 128,
                       RA = 12, BA = 200, RB = 20, BB = 176;
};
template <>
struct KrPlan<8, false> {
  static constexpr int W = 16, H = 8, HR = 8, CW = 16, CB1 = 13, CB2 = 13,
                       SH0 = 2, SH1 = -2, SH2 = 0, RECT = 1, G = 16, T = 128,
                       RA = 20, BA = 176, RB = 12, BB = 200;
};
template <>
struct KrPlan<9, false> {
  static constexpr int W = 16, H = 32, HR = 32, CW = 16, CB1 = 12, CB2 = 13,
                       SH0 = 2, SH1 = -4, SH2 = 0, RECT = 1, G = 8, T = 128,
                       RA = 20, BA = 656, RB = 36, BB = 576;
};
template <>
struct KrPlan<10, false> {
  static constexpr int W = 32, H = 16, HR = 16, CW = 32, CB1 = 13, CB2 = 13,
                       SH0 = 2, SH1 = -4, SH2 = 0, RECT = 1, G = 8, T = 128,
                       RA = 36, BA = 576, RB = 20, BB = 656;
};
template <>
struct KrPlan<11, false> {
  static constexpr int W = 32, H = 64, HR = 64, CW = 32, CB1 = 13, CB2 = 11,
                       SH0 = 0, SH1 = -2, SH2 = -2, RECT = 1, G = 2, T = 64,
                       RA = 36, BA = 2304, RB = 68, BB = 2176;
};
template <>
struct KrPlan<12, false> {
  static constexpr int W = 64, H = 32, HR = 32, CW = 64, CB1 = 12, CB2 = 11,
                       SH0 = 2, SH1 = -4, SH2 = -2, RECT = 1, G = 2, T = 64,
                       RA = 68, BA = 2176, RB = 36, BB = 2304;
};
template <>
struct KrPlan<13, false> {
  static constexpr int W = 4, H = 16, HR = 16, CW = 4, CB1 = 13, CB2 = 12,
                       SH0 = 2, SH1 = -1, SH2 = 0, RECT = 0, G = 32, T = 128,
                       RA = 4, BA = 68, RB = 20, BB = 80;
};
template <>
struct KrPlan<14, false> {
  static constexpr int W = 16, H = 4, HR = 4, CW = 16, CB1 = 13, CB2 = 13,
                       SH0 = 2, SH1 = -1, SH2 = 0, RECT = 0, G = 32, T = 128,
                       RA = 20, BA = 80, RB = 4, BB = 68;
};
template <>
struct KrPlan<15, false> {
  static constexpr int W = 8, H = 32, HR = 32, CW = 8, CB1 = 12, CB2 = 12,
                       SH0 = 2, SH1 = -2, SH2 = 0, RECT = 0, G = 16, T = 128,
                       RA = 12, BA = 392, RB = 36, BB = 288;
};
template <>
struct KrPlan<16, false> {
  static constexpr int W = 32, H = 8, HR = 8, CW = 32, CB1 = 13, CB2 = 12,
                       SH0 = 2, SH1 = -2, SH2 = 0, RECT = 0, G = 16, T = 128,
                       RA = 36, BA = 288, RB = 12, BB = 392;
};
template <>
struct KrPlan<17, false> {
  static constexpr int W = 16, H = 64, HR = 64, CW = 16, CB1 = 13, CB2 = 12,
                       SH0 = 0, SH1 = -2, SH2 = 0, RECT = 0, G = 4, T = 64,
                       RA = 20, BA = 1296, RB = 68, BB = 1088;
};
template <>
struct KrPlan<18, false> {
  static constexpr int W = 64, H = 16, HR = 16, CW = 64, CB1 = 13, CB2 = 12,
                       SH0 = 2, SH1 = -4, SH2 = 0, RECT = 0, G = 4, T = 64,
                       RA = 68, BA = 1088, RB = 20, BB = 1296;
};
template <>
struct KrPlan<0, true> {
  static constexpr int W = 4, H = 4, HR = 4, CW = 4, CB1 = 12, CB2 = 12,
                       SH0 = 0, SH1 = -4, SH2 = 0, RECT = 0, G = 32, T = 128,
                       RA = 4, BA = 36, RB = 4, BB = 36;
};
template <>
struct KrPlan<1, true> {
  static constexpr int W = 8, H = 8, HR = 8, CW = 8, CB1 = 12, CB2 = 12,
                       SH0 = -1, SH1 = -4, SH2 = 0, RECT = 0, G = 16, T = 128,
                       RA = 12, BA = 104, RB = 12, BB = 104;
};
template <>
struct KrPlan<2, true> {
  static constexpr int W = 16, H = 16, HR = 16, CW = 16, CB1 = 12, CB2 = 12,
                       SH0 = -2, SH1 = -4, SH2 = 0, RECT = 0, G = 8, T = 128,
                       RA = 20, BA = 336, RB = 20, BB = 336;
};
template <>
struct KrPlan<3, true> {
  static constexpr int W = 32, H = 32, HR = 32, CW = 32, CB1 = 12, CB2 = 12,
                       SH0 = -2, SH1 = -4, SH2 = 0, RECT = 0, G = 4, T = 128,
                       RA = 36, BA = 1152, RB = 36, BB = 1152;
};
template <>
struct KrPlan<4, true> {
  static constexpr int W = 64, H = 64, HR = 32, CW = 32, CB1 = 12, CB2 = 12,
                       SH0 = -2, SH1 = -4, SH2 = 0, RECT = 0, G = 2, T = 128,
                       RA = 68, BA = 4352, RB = 36, BB = 1152;
};
template <>
struct KrPlan<5, true> {
  static constexpr int W = 4, H = 8, HR = 8, CW = 4, CB1 = 12, CB2 = 12,
                       SH0 = 0, SH1 = -4, SH2 = 0, RECT = 1, G = 32, T = 128,
                       RA = 4, BA = 36, RB = 12, BB = 72;
};
template <>
struct KrPlan<6, true> {
  static constexpr int W = 8, H = 4, HR = 4, CW = 8, CB1 = 12, CB2 = 12,
                       SH0 = 0, SH1 = -4, SH2 = 0, RECT = 1, G = 32, T = 128,
                       RA = 12, BA = 72, RB = 4, BB = 36;
};
template <>
struct KrPlan<7, true> {
  static constexpr int W = 8, H = 16, HR = 16, CW = 8, CB1 = 12, CB2 = 12,
                       SH0 = -1, SH1 = -4, SH2 = 0, RECT = 1, G = 16, T = 128,
                       RA = 12, BA = 200, RB = 20, BB = 176;
};
template <>
struct KrPlan<8, true> {
  static constexpr int W = 16, H = 8, HR = 8, CW = 16, CB1 = 12, CB2 = 12,
                       SH0 = -1, SH1 = -4, SH2 = 0, RECT = 1, G = 16, T = 128,
                       RA = 20, BA = 176, RB = 12, BB = 200;
};
template <>
struct KrPlan<9, true> {
  static constexpr int W = 16, H = 32, HR = 32, CW = 16, CB1 = 12, CB2 = 12,
                       SH0 = -1, SH1 = -4, SH2 = 0, RECT = 1, G = 8, T = 128,
                       RA = 20, BA = 656, RB = 36, BB = 576;
};
template <>
struct KrPlan<10, true> {
  static constexpr int W = 32, H = 16, HR = 16, CW = 32, CB1 = 12, CB2 = 12,
                       SH0 = -1, SH1 = -4, SH2 = 0, RECT = 1, G = 8, T = 128,
                       RA = 36, BA = 576, RB = 20, BB = 656;
};
template <>
struct KrPlan<11, true> {
  static constexpr int W = 32, H = 64, HR = 32, CW = 32, CB1 = 12, CB2 = 12,
                       SH0 = -1, SH1 = -4, SH2 = 0, RECT = 1, G = 2, T = 64,
                       RA = 36, BA = 2304, RB = 36, BB = 1152;
};
template <>
struct KrPlan<12, true> {
  static constexpr int W = 64, H = 32, HR = 32, CW = 32, CB1 = 12, CB2 = 12,
                       SH0 = -1, SH1 = -4, SH2 = 0, RECT = 1, G = 2, T = 64,
                       RA = 68, BA = 2176, RB = 36, BB = 1152;
};
template <>
struct KrPlan<13, true> {
  static constexpr int W = 4, H = 16, HR = 16, CW = 4, CB1 = 12, CB2 = 12,
                       SH0 = -1, SH1 = -4, SH2 = 0, RECT = 0, G = 32, T = 128,
                       RA = 4, BA = 68, RB = 20, BB = 80;
};
template <>
struct KrPlan<14, true> {
  static constexpr int W = 16, H = 4, HR = 4, CW = 16, CB1 = 12, CB2 = 12,
                       SH0 = -1, SH1 = -4, SH2 = 0, RECT = 0, G = 32, T = 128,
                       RA = 20, BA = 80, RB = 4, BB = 68;
};
template <>
struct KrPlan<15, true> {
  static constexpr int W = 8, H = 32, HR = 32, CW = 8, CB1 = 12, CB2 = 12,
                       SH0 = -2, SH1 = -4, SH2 = 0, RECT = 0, G = 16, T = 128,
                       RA = 12, BA = 392, RB = 36, BB = 288;
};
template <>
struct KrPlan<16, true> {
  static constexpr int W = 32, H = 8, HR = 8, CW = 32, CB1 = 12, CB2 = 12,
                       SH0 = -2, SH1 = -4, SH2 = 0, RECT = 0, G = 16, T = 128,
                       RA = 36, BA = 288, RB = 12, BB = 392;
};
template <>
struct KrPlan<17, true> {
  static constexpr int W = 16, H = 64, HR = 32, CW = 16, CB1 = 12, CB2 = 12,
                       SH0 = -2, SH1 = -4, SH2 = 0, RECT = 0, G = 4, T = 64,
                       RA = 20, BA = 1296, RB = 36, BB = 576;
};
template <>
struct KrPlan<18, true> {
  static constexpr int W = 64, H = 16, HR = 16, CW = 32, CB1 = 12, CB2 = 12,
                       SH0 = -2, SH1 = -4, SH2 = 0, RECT = 0, G = 4, T = 64,
                       RA = 68, BA = 1088, RB = 20, BB = 656;
};

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_fdct4(int (&x)[4], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  // stage 1
  const int t0 = add32(x0, x3);
  const int t1 = add32(x1, x2);
  const int t2 = sub32(x1, x2);
  const int t3 = sub32(x0, x3);
  // stage 2
  const int t4 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t0, t1);
  const int t5 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t1, t0);
  const int t6 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t2, t3);
  const int t7 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t3, t2);
  // stage 3
  x[0] = t4;
  x[1] = t6;
  x[2] = t5;
  x[3] = t7;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_fdct8(int (&x)[8], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  const int x4 = x[4];
  const int x5 = x[5];
  const int x6 = x[6];
  const int x7 = x[7];
  // stage 1
  const int t0 = add32(x0, x7);
  const int t1 = add32(x1, x6);
  const int t2 = add32(x2, x5);
  const int t3 = add32(x3, x4);
  const int t4 = sub32(x3, x4);
  const int t5 = sub32(x2, x5);
  const int t6 = sub32(x1, x6);
  const int t7 = sub32(x0, x7);
  // stage 2
  const int t8 = add32(t0, t3);
  const int t9 = add32(t1, t2);
  const int t10 = sub32(t1, t2);
  const int t11 = sub32(t0, t3);
  const int t12 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t5, t6);
  const int t13 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t6, t5);
  // stage 3
  const int t14 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t8, t9);
  const int t15 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t9, t8);
  const int t16 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t10, t11);
  const int t17 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t11, t10);
  const int t18 = add32(t4, t12);
  const int t19 = sub32(t4, t12);
  const int t20 = sub32(t7, t13);
  const int t21 = add32(t7, t13);
  // stage 4
  const int t22 = kr_btf<CB, kr_cospi(CB, 56), kr_cospi(CB, 8)>(t18, t21);
  const int t23 = kr_btf<CB, kr_cospi(CB, 24), kr_cospi(CB, 40)>(t19, t20);
  const int t24 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t20, t19);
  const int t25 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t21, t18);
  // stage 5
  x[0] = t14;
  x[1] = t22;
  x[2] = t16;
  x[3] = t24;
  x[4] = t15;
  x[5] = t23;
  x[6] = t17;
  x[7] = t25;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_fdct16(int (&x)[16], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  const int x4 = x[4];
  const int x5 = x[5];
  const int x6 = x[6];
  const int x7 = x[7];
  const int x8 = x[8];
  const int x9 = x[9];
  const int x10 = x[10];
  const int x11 = x[11];
  const int x12 = x[12];
  const int x13 = x[13];
  const int x14 = x[14];
  const int x15 = x[15];
  // stage 1
  const int t0 = add32(x0, x15);
  const int t1 = add32(x1, x14);
  const int t2 = add32(x2, x13);
  const int t3 = add32(x3, x12);
  const int t4 = add32(x4, x11);
  const int t5 = add32(x5, x10);
  const int t6 = add32(x6, x9);
  const int t7 = add32(x7, x8);
  const int t8 = sub32(x7, x8);
  const int t9 = sub32(x6, x9);
  const int t10 = sub32(x5, x10);
  const int t11 = sub32(x4, x11);
  const int t12 = sub32(x3, x12);
  const int t13 = sub32(x2, x13);
  const int t14 = sub32(x1, x14);
  const int t15 = sub32(x0, x15);
  // stage 2
  const int t16 = add32(t0, t7);
  const int t17 = add32(t1, t6);
  const int t18 = add32(t2, t5);
  const int t19 = add32(t3, t4);
  const int t20 = sub32(t3, t4);
  const int t21 = sub32(t2, t5);
  const int t22 = sub32(t1, t6);
  const int t23 = sub32(t0, t7);
  const int t24 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t10, t13);
  const int t25 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t11, t12);
  const int t26 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t12, t11);
  const int t27 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t13, t10);
  // stage 3
  const int t28 = add32(t16, t19);
  const int t29 = add32(t17, t18);
  const int t30 = sub32(t17, t18);
  const int t31 = sub32(t16, t19);
  const int t32 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t21, t22);
  const int t33 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t22, t21);
  const int t34 = add32(t8, t25);
  const int t35 = add32(t9, t24);
  const int t36 = sub32(t9, t24);
  const int t37 = sub32(t8, t25);
  const int t38 = sub32(t15, t26);
  const int t39 = sub32(t14, t27);
  const int t40 = add32(t14, t27);
  const int t41 = add32(t15, t26);
  // stage 4
  const int t42 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t28, t29);
  const int t43 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t29, t28);
  const int t44 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t30, t31);
  const int t45 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t31, t30);
  const int t46 = add32(t20, t32);
  const int t47 = sub32(t20, t32);
  const int t48 = sub32(t23, t33);
  const int t49 = add32(t23, t33);
  const int t50 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t35, t40);
  const int t51 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t36, t39);
  const int t52 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t39, t36);
  const int t53 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t40, t35);
  // stage 5
  const int t54 = kr_btf<CB, kr_cospi(CB, 56), kr_cospi(CB, 8)>(t46, t49);
  const int t55 = kr_btf<CB, kr_cospi(CB, 24), kr_cospi(CB, 40)>(t47, t48);
  const int t56 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t48, t47);
  const int t57 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t49, t46);
  const int t58 = add32(t34, t50);
  const int t59 = sub32(t34, t50);
  const int t60 = sub32(t37, t51);
  const int t61 = add32(t37, t51);
  const int t62 = add32(t38, t52);
  const int t63 = sub32(t38, t52);
  const int t64 = sub32(t41, t53);
  const int t65 = add32(t41, t53);
  // stage 6
  const int t66 = kr_btf<CB, kr_cospi(CB, 60), kr_cospi(CB, 4)>(t58, t65);
  const int t67 = kr_btf<CB, kr_cospi(CB, 28), kr_cospi(CB, 36)>(t59, t64);
  const int t68 = kr_btf<CB, kr_cospi(CB, 44), kr_cospi(CB, 20)>(t60, t63);
  const int t69 = kr_btf<CB, kr_cospi(CB, 12), kr_cospi(CB, 52)>(t61, t62);
  const int t70 = kr_btf<CB, kr_cospi(CB, 12), -kr_cospi(CB, 52)>(t62, t61);
  const int t71 = kr_btf<CB, kr_cospi(CB, 44), -kr_cospi(CB, 20)>(t63, t60);
  const int t72 = kr_btf<CB, kr_cospi(CB, 28), -kr_cospi(CB, 36)>(t64, t59);
  const int t73 = kr_btf<CB, kr_cospi(CB, 60), -kr_cospi(CB, 4)>(t65, t58);
  // stage 7
  x[0] = t42;
  x[1] = t66;
  x[2] = t54;
  x[3] = t70;
  x[4] = t44;
  x[5] = t68;
  x[6] = t56;
  x[7] = t72;
  x[8] = t43;
  x[9] = t67;
  x[10] = t55;
  x[11] = t71;
  x[12] = t45;
  x[13] = t69;
  x[14] = t57;
  x[15] = t73;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_fdct32(int (&x)[32], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  const int x4 = x[4];
  const int x5 = x[5];
  const int x6 = x[6];
  const int x7 = x[7];
  const int x8 = x[8];
  const int x9 = x[9];
  const int x10 = x[10];
  const int x11 = x[11];
  const int x12 = x[12];
  const int x13 = x[13];
  const int x14 = x[14];
  const int x15 = x[15];
  const int x16 = x[16];
  const int x17 = x[17];
  const int x18 = x[18];
  const int x19 = x[19];
  const int x20 = x[20];
  const int x21 = x[21];
  const int x22 = x[22];
  const int x23 = x[23];
  const int x24 = x[24];
  const int x25 = x[25];
  const int x26 = x[26];
  const int x27 = x[27];
  const int x28 = x[28];
  const int x29 = x[29];
  const int x30 = x[30];
  const int x31 = x[31];
  // stage 1
  const int t0 = add32(x0, x31);
  const int t1 = add32(x1, x30);
  const int t2 = add32(x2, x29);
  const int t3 = add32(x3, x28);
  const int t4 = add32(x4, x27);
  const int t5 = add32(x5, x26);
  const int t6 = add32(x6, x25);
  const int t7 = add32(x7, x24);
  const int t8 = add32(x8, x23);
  const int t9 = add32(x9, x22);
  const int t10 = add32(x10, x21);
  const int t11 = add32(x11, x20);
  const int t12 = add32(x12, x19);
  const int t13 = add32(x13, x18);
  const int t14 = add32(x14, x17);
  const int t15 = add32(x15, x16);
  const int t16 = sub32(x15, x16);
  const int t17 = sub32(x14, x17);
  const int t18 = sub32(x13, x18);
  const int t19 = sub32(x12, x19);
  const int t20 = sub32(x11, x20);
  const int t21 = sub32(x10, x21);
  const int t22 = sub32(x9, x22);
  const int t23 = sub32(x8, x23);
  const int t24 = sub32(x7, x24);
  const int t25 = sub32(x6, x25);
  const int t26 = sub32(x5, x26);
  const int t27 = sub32(x4, x27);
  const int t28 = sub32(x3, x28);
  const int t29 = sub32(x2, x29);
  const int t30 = sub32(x1, x30);
  const int t31 = sub32(x0, x31);
  // stage 2
  const int t32 = add32(t0, t15);
  const int t33 = add32(t1, t14);
  const int t34 = add32(t2, t13);
  const int t35 = add32(t3, t12);
  const int t36 = add32(t4, t11);
  const int t37 = add32(t5, t10);
  const int t38 = add32(t6, t9);
  const int t39 = add32(t7, t8);
  const int t40 = sub32(t7, t8);
  const int t41 = sub32(t6, t9);
  const int t42 = sub32(t5, t10);
  const int t43 = sub32(t4, t11);
  const int t44 = sub32(t3, t12);
  const int t45 = sub32(t2, t13);
  const int t46 = sub32(t1, t14);
  const int t47 = sub32(t0, t15);
  const int t48 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t20, t27);
  const int t49 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t21, t26);
  const int t50 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t22, t25);
  const int t51 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t23, t24);
  const int t52 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t24, t23);
  const int t53 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t25, t22);
  const int t54 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t26, t21);
  const int t55 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t27, t20);
  // stage 3
  const int t56 = add32(t32, t39);
  const int t57 = add32(t33, t38);
  const int t58 = add32(t34, t37);
  const int t59 = add32(t35, t36);
  const int t60 = sub32(t35, t36);
  const int t61 = sub32(t34, t37);
  const int t62 = sub32(t33, t38);
  const int t63 = sub32(t32, t39);
  const int t64 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t42, t45);
  const int t65 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t43, t44);
  const int t66 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t44, t43);
  const int t67 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t45, t42);
  const int t68 = add32(t16, t51);
  const int t69 = add32(t17, t50);
  const int t70 = add32(t18, t49);
  const int t71 = add32(t19, t48);
  const int t72 = sub32(t19, t48);
  const int t73 = sub32(t18, t49);
  const int t74 = sub32(t17, t50);
  const int t75 = sub32(t16, t51);
  const int t76 = sub32(t31, t52);
  const int t77 = sub32(t30, t53);
  const int t78 = sub32(t29, t54);
  const int t79 = sub32(t28, t55);
  const int t80 = add32(t28, t55);
  const int t81 = add32(t29, t54);
  const int t82 = add32(t30, t53);
  const int t83 = add32(t31, t52);
  // stage 4
  const int t84 = add32(t56, t59);
  const int t85 = add32(t57, t58);
  const int t86 = sub32(t57, t58);
  const int t87 = sub32(t56, t59);
  const int t88 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t61, t62);
  const int t89 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t62, t61);
  const int t90 = add32(t40, t65);
  const int t91 = add32(t41, t64);
  const int t92 = sub32(t41, t64);
  const int t93 = sub32(t40, t65);
  const int t94 = sub32(t47, t66);
  const int t95 = sub32(t46, t67);
  const int t96 = add32(t46, t67);
  const int t97 = add32(t47, t66);
  const int t98 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t70, t81);
  const int t99 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t71, t80);
  const int t100 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t72, t79);
  const int t101 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t73, t78);
  const int t102 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t78, t73);
  const int t103 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t79, t72);
  const int t104 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t80, t71);
  const int t105 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t81, t70);
  // stage 5
  const int t106 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t84, t85);
  const int t107 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t85, t84);
  const int t108 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t86, t87);
  const int t109 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t87, t86);
  const int t110 = add32(t60, t88);
  const int t111 = sub32(t60, t88);
  const int t112 = sub32(t63, t89);
  const int t113 = add32(t63, t89);
  const int t114 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t91, t96);
  const int t115 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t92, t95);
  const int t116 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t95, t92);
  const int t117 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t96, t91);
  const int t118 = add32(t68, t99);
  const int t119 = add32(t69, t98);
  const int t120 = sub32(t69, t98);
  const int t121 = sub32(t68, t99);
  const int t122 = sub32(t75, t100);
  const int t123 = sub32(t74, t101);
  const int t124 = add32(t74, t101);
  const int t125 = add32(t75, t100);
  const int t126 = add32(t76, t103);
  const int t127 = add32(t77, t102);
  const int t128 = sub32(t77, t102);
  const int t129 = sub32(t76, t103);
  const int t130 = sub32(t83, t104);
  const int t131 = sub32(t82, t105);
  const int t132 = add32(t82, t105);
  const int t133 = add32(t83, t104);
  // stage 6
  const int t134 = kr_btf<CB, kr_cospi(CB, 56), kr_cospi(CB, 8)>(t110, t113);
  const int t135 = kr_btf<CB, kr_cospi(CB, 24), kr_cospi(CB, 40)>(t111, t112);
  const int t136 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t112, t111);
  const int t137 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t113, t110);
  const int t138 = add32(t90, t114);
  const int t139 = sub32(t90, t114);
  const int t140 = sub32(t93, t115);
  const int t141 = add32(t93, t115);
  const int t142 = add32(t94, t116);
  const int t143 = sub32(t94, t116);
  const int t144 = sub32(t97, t117);
  const int t145 = add32(t97, t117);
  const int t146 = kr_btf<CB, -kr_cospi(CB, 8), kr_cospi(CB, 56)>(t119, t132);
  const int t147 = kr_btf<CB, -kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t120, t131);
  const int t148 = kr_btf<CB, -kr_cospi(CB, 40), kr_cospi(CB, 24)>(t123, t128);
  const int t149 = kr_btf<CB, -kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t124, t127);
  const int t150 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t127, t124);
  const int t151 = kr_btf<CB, kr_cospi(CB, 40), kr_cospi(CB, 24)>(t128, t123);
  const int t152 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t131, t120);
  const int t153 = kr_btf<CB, kr_cospi(CB, 8), kr_cospi(CB, 56)>(t132, t119);
  // stage 7
  const int t154 = kr_btf<CB, kr_cospi(CB, 60), kr_cospi(CB, 4)>(t138, t145);
  const int t155 = kr_btf<CB, kr_cospi(CB, 28), kr_cospi(CB, 36)>(t139, t144);
  const int t156 = kr_btf<CB, kr_cospi(CB, 44), kr_cospi(CB, 20)>(t140, t143);
  const int t157 = kr_btf<CB, kr_cospi(CB, 12), kr_cospi(CB, 52)>(t141, t142);
  const int t158 = kr_btf<CB, kr_cospi(CB, 12), -kr_cospi(CB, 52)>(t142, t141);
  const int t159 = kr_btf<CB, kr_cospi(CB, 44), -kr_cospi(CB, 20)>(t143, t140);
  const int t160 = kr_btf<CB, kr_cospi(CB, 28), -kr_cospi(CB, 36)>(t144, t139);
  const int t161 = kr_btf<CB, kr_cospi(CB, 60), -kr_cospi(CB, 4)>(t145, t138);
  const int t162 = add32(t118, t146);
  const int t163 = sub32(t118, t146);
  const int t164 = sub32(t121, t147);
  const int t165 = add32(t121, t147);
  const int t166 = add32(t122, t148);
  const int t167 = sub32(t122, t148);
  const int t168 = sub32(t125, t149);
  const int t169 = add32(t125, t149);
  const int t170 = add32(t126, t150);
  const int t171 = sub32(t126, t150);
  const int t172 = sub32(t129, t151);
  const int t173 = add32(t129, t151);
  const int t174 = add32(t130, t152);
  const int t175 = sub32(t130, t152);
  const int t176 = sub32(t133, t153);
  const int t177 = add32(t133, t153);
  // stage 8
  const int t178 = kr_btf<CB, kr_cospi(CB, 62), kr_cospi(CB, 2)>(t162, t177);
  const int t179 = kr_btf<CB, kr_cospi(CB, 30), kr_cospi(CB, 34)>(t163, t176);
  const int t180 = kr_btf<CB, kr_cospi(CB, 46), kr_cospi(CB, 18)>(t164, t175);
  const int t181 = kr_btf<CB, kr_cospi(CB, 14), kr_cospi(CB, 50)>(t165, t174);
  const int t182 = kr_btf<CB, kr_cospi(CB, 54), kr_cospi(CB, 10)>(t166, t173);
  const int t183 = kr_btf<CB, kr_cospi(CB, 22), kr_cospi(CB, 42)>(t167, t172);
  const int t184 = kr_btf<CB, kr_cospi(CB, 38), kr_cospi(CB, 26)>(t168, t171);
  const int t185 = kr_btf<CB, kr_cospi(CB, 6), kr_cospi(CB, 58)>(t169, t170);
  const int t186 = kr_btf<CB, kr_cospi(CB, 6), -kr_cospi(CB, 58)>(t170, t169);
  const int t187 = kr_btf<CB, kr_cospi(CB, 38), -kr_cospi(CB, 26)>(t171, t168);
  const int t188 = kr_btf<CB, kr_cospi(CB, 22), -kr_cospi(CB, 42)>(t172, t167);
  const int t189 = kr_btf<CB, kr_cospi(CB, 54), -kr_cospi(CB, 10)>(t173, t166);
  const int t190 = kr_btf<CB, kr_cospi(CB, 14), -kr_cospi(CB, 50)>(t174, t165);
  const int t191 = kr_btf<CB, kr_cospi(CB, 46), -kr_cospi(CB, 18)>(t175, t164);
  const int t192 = kr_btf<CB, kr_cospi(CB, 30), -kr_cospi(CB, 34)>(t176, t163);
  const int t193 = kr_btf<CB, kr_cospi(CB, 62), -kr_cospi(CB, 2)>(t177, t162);
  // stage 9
  x[0] = t106;
  x[1] = t178;
  x[2] = t154;
  x[3] = t186;
  x[4] = t134;
  x[5] = t182;
  x[6] = t158;
  x[7] = t190;
  x[8] = t108;
  x[9] = t180;
  x[10] = t156;
  x[11] = t188;
  x[12] = t136;
  x[13] = t184;
  x[14] = t160;
  x[15] = t192;
  x[16] = t107;
  x[17] = t179;
  x[18] = t155;
  x[19] = t187;
  x[20] = t135;
  x[21] = t183;
  x[22] = t159;
  x[23] = t191;
  x[24] = t109;
  x[25] = t181;
  x[26] = t157;
  x[27] = t189;
  x[28] = t137;
  x[29] = t185;
  x[30] = t161;
  x[31] = t193;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_fdct64(int (&x)[64], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  const int x4 = x[4];
  const int x5 = x[5];
  const int x6 = x[6];
  const int x7 = x[7];
  const int x8 = x[8];
  const int x9 = x[9];
  const int x10 = x[10];
  const int x11 = x[11];
  const int x12 = x[12];
  const int x13 = x[13];
  const int x14 = x[14];
  const int x15 = x[15];
  const int x16 = x[16];
  const int x17 = x[17];
  const int x18 = x[18];
  const int x19 = x[19];
  const int x20 = x[20];
  const int x21 = x[21];
  const int x22 = x[22];
  const int x23 = x[23];
  const int x24 = x[24];
  const int x25 = x[25];
  const int x26 = x[26];
  const int x27 = x[27];
  const int x28 = x[28];
  const int x29 = x[29];
  const int x30 = x[30];
  const int x31 = x[31];
  const int x32 = x[32];
  const int x33 = x[33];
  const int x34 = x[34];
  const int x35 = x[35];
  const int x36 = x[36];
  const int x37 = x[37];
  const int x38 = x[38];
  const int x39 = x[39];
  const int x40 = x[40];
  const int x41 = x[41];
  const int x42 = x[42];
  const int x43 = x[43];
  const int x44 = x[44];
  const int x45 = x[45];
  const int x46 = x[46];
  const int x47 = x[47];
  const int x48 = x[48];
  const int x49 = x[49];
  const int x50 = x[50];
  const int x51 = x[51];
  const int x52 = x[52];
  const int x53 = x[53];
  const int x54 = x[54];
  const int x55 = x[55];
  const int x56 = x[56];
  const int x57 = x[57];
  const int x58 = x[58];
  const int x59 = x[59];
  const int x60 = x[60];
  const int x61 = x[61];
  const int x62 = x[62];
  const int x63 = x[63];
  // stage 1
  const int t0 = add32(x0, x63);
  const int t1 = add32(x1, x62);
  const int t2 = add32(x2, x61);
  const int t3 = add32(x3, x60);
  const int t4 = add32(x4, x59);
  const int t5 = add32(x5, x58);
  const int t6 = add32(x6, x57);
  const int t7 = add32(x7, x56);
  const int t8 = add32(x8, x55);
  const int t9 = add32(x9, x54);
  const int t10 = add32(x10, x53);
  const int t11 = add32(x11, x52);
  const int t12 = add32(x12, x51);
  const int t13 = add32(x13, x50);
  const int t14 = add32(x14, x49);
  const int t15 = add32(x15, x48);
  const int t16 = add32(x16, x47);
  const int t17 = add32(x17, x46);
  const int t18 = add32(x18, x45);
  const int t19 = add32(x19, x44);
  const int t20 = add32(x20, x43);
  const int t21 = add32(x21, x42);
  const int t22 = add32(x22, x41);
  const int t23 = add32(x23, x40);
  const int t24 = add32(x24, x39);
  const int t25 = add32(x25, x38);
  const int t26 = add32(x26, x37);
  const int t27 = add32(x27, x36);
  const int t28 = add32(x28, x35);
  const int t29 = add32(x29, x34);
  const int t30 = add32(x30, x33);
  const int t31 = add32(x31, x32);
  const int t32 = sub32(x31, x32);
  const int t33 = sub32(x30, x33);
  const int t34 = sub32(x29, x34);
  const int t35 = sub32(x28, x35);
  const int t36 = sub32(x27, x36);
  const int t37 = sub32(x26, x37);
  const int t38 = sub32(x25, x38);
  const int t39 = sub32(x24, x39);
  const int t40 = sub32(x23, x40);
  const int t41 = sub32(x22, x41);
  const int t42 = sub32(x21, x42);
  const int t43 = sub32(x20, x43);
  const int t44 = sub32(x19, x44);
  const int t45 = sub32(x18, x45);
  const int t46 = sub32(x17, x46);
  const int t47 = sub32(x16, x47);
  const int t48 = sub32(x15, x48);
  const int t49 = sub32(x14, x49);
  const int t50 = sub32(x13, x50);
  const int t51 = sub32(x12, x51);
  const int t52 = sub32(x11, x52);
  const int t53 = sub32(x10, x53);
  const int t54 = sub32(x9, x54);
  const int t55 = sub32(x8, x55);
  const int t56 = sub32(x7, x56);
  const int t57 = sub32(x6, x57);
  const int t58 = sub32(x5, x58);
  const int t59 = sub32(x4, x59);
  const int t60 = sub32(x3, x60);
  const int t61 = sub32(x2, x61);
  const int t62 = sub32(x1, x62);
  const int t63 = sub32(x0, x63);
  // stage 2
  const int t64 = add32(t0, t31);
  const int t65 = add32(t1, t30);
  const int t66 = add32(t2, t29);
  const int t67 = add32(t3, t28);
  const int t68 = add32(t4, t27);
  const int t69 = add32(t5, t26);
  const int t70 = add32(t6, t25);
  const int t71 = add32(t7, t24);
  const int t72 = add32(t8, t23);
  const int t73 = add32(t9, t22);
  const int t74 = add32(t10, t21);
  const int t75 = add32(t11, t20);
  const int t76 = add32(t12, t19);
  const int t77 = add32(t13, t18);
  const int t78 = add32(t14, t17);
  const int t79 = add32(t15, t16);
  const int t80 = sub32(t15, t16);
  const int t81 = sub32(t14, t17);
  const int t82 = sub32(t13, t18);
  const int t83 = sub32(t12, t19);
  const int t84 = sub32(t11, t20);
  const int t85 = sub32(t10, t21);
  const int t86 = sub32(t9, t22);
  const int t87 = sub32(t8, t23);
  const int t88 = sub32(t7, t24);
  const int t89 = sub32(t6, t25);
  const int t90 = sub32(t5, t26);
  const int t91 = sub32(t4, t27);
  const int t92 = sub32(t3, t28);
  const int t93 = sub32(t2, t29);
  const int t94 = sub32(t1, t30);
  const int t95 = sub32(t0, t31);
  const int t96 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t40, t55);
  const int t97 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t41, t54);
  const int t98 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t42, t53);
  const int t99 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t43, t52);
  const int t100 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t44, t51);
  const int t101 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t45, t50);
  const int t102 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t46, t49);
  const int t103 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t47, t48);
  const int t104 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t48, t47);
  const int t105 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t49, t46);
  const int t106 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t50, t45);
  const int t107 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t51, t44);
  const int t108 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t52, t43);
  const int t109 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t53, t42);
  const int t110 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t54, t41);
  const int t111 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t55, t40);
  // stage 3
  const int t112 = add32(t64, t79);
  const int t113 = add32(t65, t78);
  const int t114 = add32(t66, t77);
  const int t115 = add32(t67, t76);
  const int t116 = add32(t68, t75);
  const int t117 = add32(t69, t74);
  const int t118 = add32(t70, t73);
  const int t119 = add32(t71, t72);
  const int t120 = sub32(t71, t72);
  const int t121 = sub32(t70, t73);
  const int t122 = sub32(t69, t74);
  const int t123 = sub32(t68, t75);
  const int t124 = sub32(t67, t76);
  const int t125 = sub32(t66, t77);
  const int t126 = sub32(t65, t78);
  const int t127 = sub32(t64, t79);
  const int t128 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t84, t91);
  const int t129 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t85, t90);
  const int t130 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t86, t89);
  const int t131 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t87, t88);
  const int t132 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t88, t87);
  const int t133 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t89, t86);
  const int t134 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t90, t85);
  const int t135 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t91, t84);
  const int t136 = add32(t32, t103);
  const int t137 = add32(t33, t102);
  const int t138 = add32(t34, t101);
  const int t139 = add32(t35, t100);
  const int t140 = add32(t36, t99);
  const int t141 = add32(t37, t98);
  const int t142 = add32(t38, t97);
  const int t143 = add32(t39, t96);
  const int t144 = sub32(t39, t96);
  const int t145 = sub32(t38, t97);
  const int t146 = sub32(t37, t98);
  const int t147 = sub32(t36, t99);
  const int t148 = sub32(t35, t100);
  const int t149 = sub32(t34, t101);
  const int t150 = sub32(t33, t102);
  const int t151 = sub32(t32, t103);
  const int t152 = sub32(t63, t104);
  const int t153 = sub32(t62, t105);
  const int t154 = sub32(t61, t106);
  const int t155 = sub32(t60, t107);
  const int t156 = sub32(t59, t108);
  const int t157 = sub32(t58, t109);
  const int t158 = sub32(t57, t110);
  const int t159 = sub32(t56, t111);
  const int t160 = add32(t56, t111);
  const int t161 = add32(t57, t110);
  const int t162 = add32(t58, t109);
  const int t163 = add32(t59, t108);
  const int t164 = add32(t60, t107);
  const int t165 = add32(t61, t106);
  const int t166 = add32(t62, t105);
  const int t167 = add32(t63, t104);
  // stage 4
  const int t168 = add32(t112, t119);
  const int t169 = add32(t113, t118);
  const int t170 = add32(t114, t117);
  const int t171 = add32(t115, t116);
  const int t172 = sub32(t115, t116);
  const int t173 = sub32(t114, t117);
  const int t174 = sub32(t113, t118);
  const int t175 = sub32(t112, t119);
  const int t176 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t122, t125);
  const int t177 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t123, t124);
  const int t178 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t124, t123);
  const int t179 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t125, t122);
  const int t180 = add32(t80, t131);
  const int t181 = add32(t81, t130);
  const int t182 = add32(t82, t129);
  const int t183 = add32(t83, t128);
  const int t184 = sub32(t83, t128);
  const int t185 = sub32(t82, t129);
  const int t186 = sub32(t81, t130);
  const int t187 = sub32(t80, t131);
  const int t188 = sub32(t95, t132);
  const int t189 = sub32(t94, t133);
  const int t190 = sub32(t93, t134);
  const int t191 = sub32(t92, t135);
  const int t192 = add32(t92, t135);
  const int t193 = add32(t93, t134);
  const int t194 = add32(t94, t133);
  const int t195 = add32(t95, t132);
  const int t196 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t140, t163);
  const int t197 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t141, t162);
  const int t198 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t142, t161);
  const int t199 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t143, t160);
  const int t200 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t144, t159);
  const int t201 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t145, t158);
  const int t202 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t146, t157);
  const int t203 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t147, t156);
  const int t204 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t156, t147);
  const int t205 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t157, t146);
  const int t206 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t158, t145);
  const int t207 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t159, t144);
  const int t208 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t160, t143);
  const int t209 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t161, t142);
  const int t210 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t162, t141);
  const int t211 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t163, t140);
  // stage 5
  const int t212 = add32(t168, t171);
  const int t213 = add32(t169, t170);
  const int t214 = sub32(t169, t170);
  const int t215 = sub32(t168, t171);
  const int t216 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t173, t174);
  const int t217 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t174, t173);
  const int t218 = add32(t120, t177);
  const int t219 = add32(t121, t176);
  const int t220 = sub32(t121, t176);
  const int t221 = sub32(t120, t177);
  const int t222 = sub32(t127, t178);
  const int t223 = sub32(t126, t179);
  const int t224 = add32(t126, t179);
  const int t225 = add32(t127, t178);
  const int t226 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t182, t193);
  const int t227 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t183, t192);
  const int t228 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t184, t191);
  const int t229 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t185, t190);
  const int t230 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t190, t185);
  const int t231 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t191, t184);
  const int t232 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t192, t183);
  const int t233 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t193, t182);
  const int t234 = add32(t136, t199);
  const int t235 = add32(t137, t198);
  const int t236 = add32(t138, t197);
  const int t237 = add32(t139, t196);
  const int t238 = sub32(t139, t196);
  const int t239 = sub32(t138, t197);
  const int t240 = sub32(t137, t198);
  const int t241 = sub32(t136, t199);
  const int t242 = sub32(t151, t200);
  const int t243 = sub32(t150, t201);
  const int t244 = sub32(t149, t202);
  const int t245 = sub32(t148, t203);
  const int t246 = add32(t148, t203);
  const int t247 = add32(t149, t202);
  const int t248 = add32(t150, t201);
  const int t249 = add32(t151, t200);
  const int t250 = add32(t152, t207);
  const int t251 = add32(t153, t206);
  const int t252 = add32(t154, t205);
  const int t253 = add32(t155, t204);
  const int t254 = sub32(t155, t204);
  const int t255 = sub32(t154, t205);
  const int t256 = sub32(t153, t206);
  const int t257 = sub32(t152, t207);
  const int t258 = sub32(t167, t208);
  const int t259 = sub32(t166, t209);
  const int t260 = sub32(t165, t210);
  const int t261 = sub32(t164, t211);
  const int t262 = add32(t164, t211);
  const int t263 = add32(t165, t210);
  const int t264 = add32(t166, t209);
  const int t265 = add32(t167, t208);
  // stage 6
  const int t266 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t212, t213);
  const int t267 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t213, t212);
  const int t268 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t214, t215);
  const int t269 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t215, t214);
  const int t270 = add32(t172, t216);
  const int t271 = sub32(t172, t216);
  const int t272 = sub32(t175, t217);
  const int t273 = add32(t175, t217);
  const int t274 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t219, t224);
  const int t275 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t220, t223);
  const int t276 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t223, t220);
  const int t277 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t224, t219);
  const int t278 = add32(t180, t227);
  const int t279 = add32(t181, t226);
  const int t280 = sub32(t181, t226);
  const int t281 = sub32(t180, t227);
  const int t282 = sub32(t187, t228);
  const int t283 = sub32(t186, t229);
  const int t284 = add32(t186, t229);
  const int t285 = add32(t187, t228);
  const int t286 = add32(t188, t231);
  const int t287 = add32(t189, t230);
  const int t288 = sub32(t189, t230);
  const int t289 = sub32(t188, t231);
  const int t290 = sub32(t195, t232);
  const int t291 = sub32(t194, t233);
  const int t292 = add32(t194, t233);
  const int t293 = add32(t195, t232);
  const int t294 = kr_btf<CB, -kr_cospi(CB, 8), kr_cospi(CB, 56)>(t236, t263);
  const int t295 = kr_btf<CB, -kr_cospi(CB, 8), kr_cospi(CB, 56)>(t237, t262);
  const int t296 = kr_btf<CB, -kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t238, t261);
  const int t297 = kr_btf<CB, -kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t239, t260);
  const int t298 = kr_btf<CB, -kr_cospi(CB, 40), kr_cospi(CB, 24)>(t244, t255);
  const int t299 = kr_btf<CB, -kr_cospi(CB, 40), kr_cospi(CB, 24)>(t245, t254);
  const int t300 = kr_btf<CB, -kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t246, t253);
  const int t301 = kr_btf<CB, -kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t247, t252);
  const int t302 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t252, t247);
  const int t303 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t253, t246);
  const int t304 = kr_btf<CB, kr_cospi(CB, 40), kr_cospi(CB, 24)>(t254, t245);
  const int t305 = kr_btf<CB, kr_cospi(CB, 40), kr_cospi(CB, 24)>(t255, t244);
  const int t306 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t260, t239);
  const int t307 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t261, t238);
  const int t308 = kr_btf<CB, kr_cospi(CB, 8), kr_cospi(CB, 56)>(t262, t237);
  const int t309 = kr_btf<CB, kr_cospi(CB, 8), kr_cospi(CB, 56)>(t263, t236);
  // stage 7
  const int t310 = kr_btf<CB, kr_cospi(CB, 56), kr_cospi(CB, 8)>(t270, t273);
  const int t311 = kr_btf<CB, kr_cospi(CB, 24), kr_cospi(CB, 40)>(t271, t272);
  const int t312 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t272, t271);
  const int t313 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t273, t270);
  const int t314 = add32(t218, t274);
  const int t315 = sub32(t218, t274);
  const int t316 = sub32(t221, t275);
  const int t317 = add32(t221, t275);
  const int t318 = add32(t222, t276);
  const int t319 = sub32(t222, t276);
  const int t320 = sub32(t225, t277);
  const int t321 = add32(t225, t277);
  const int t322 = kr_btf<CB, -kr_cospi(CB, 8), kr_cospi(CB, 56)>(t279, t292);
  const int t323 = kr_btf<CB, -kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t280, t291);
  const int t324 = kr_btf<CB, -kr_cospi(CB, 40), kr_cospi(CB, 24)>(t283, t288);
  const int t325 = kr_btf<CB, -kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t284, t287);
  const int t326 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t287, t284);
  const int t327 = kr_btf<CB, kr_cospi(CB, 40), kr_cospi(CB, 24)>(t288, t283);
  const int t328 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t291, t280);
  const int t329 = kr_btf<CB, kr_cospi(CB, 8), kr_cospi(CB, 56)>(t292, t279);
  const int t330 = add32(t234, t295);
  const int t331 = add32(t235, t294);
  const int t332 = sub32(t235, t294);
  const int t333 = sub32(t234, t295);
  const int t334 = sub32(t241, t296);
  const int t335 = sub32(t240, t297);
  const int t336 = add32(t240, t297);
  const int t337 = add32(t241, t296);
  const int t338 = add32(t242, t299);
  const int t339 = add32(t243, t298);
  const int t340 = sub32(t243, t298);
  const int t341 = sub32(t242, t299);
  const int t342 = sub32(t249, t300);
  const int t343 = sub32(t248, t301);
  const int t344 = add32(t248, t301);
  const int t345 = add32(t249, t300);
  const int t346 = add32(t250, t303);
  const int t347 = add32(t251, t302);
  const int t348 = sub32(t251, t302);
  const int t349 = sub32(t250, t303);
  const int t350 = sub32(t257, t304);
  const int t351 = sub32(t256, t305);
  const int t352 = add32(t256, t305);
  const int t353 = add32(t257, t304);
  const int t354 = add32(t258, t307);
  const int t355 = add32(t259, t306);
  const int t356 = sub32(t259, t306);
  const int t357 = sub32(t258, t307);
  const int t358 = sub32(t265, t308);
  const int t359 = sub32(t264, t309);
  const int t360 = add32(t264, t309);
  const int t361 = add32(t265, t308);
  // stage 8
  const int t362 = kr_btf<CB, kr_cospi(CB, 60), kr_cospi(CB, 4)>(t314, t321);
  const int t363 = kr_btf<CB, kr_cospi(CB, 28), kr_cospi(CB, 36)>(t315, t320);
  const int t364 = kr_btf<CB, kr_cospi(CB, 44), kr_cospi(CB, 20)>(t316, t319);
  const int t365 = kr_btf<CB, kr_cospi(CB, 12), kr_cospi(CB, 52)>(t317, t318);
  const int t366 = kr_btf<CB, kr_cospi(CB, 12), -kr_cospi(CB, 52)>(t318, t317);
  const int t367 = kr_btf<CB, kr_cospi(CB, 44), -kr_cospi(CB, 20)>(t319, t316);
  const int t368 = kr_btf<CB, kr_cospi(CB, 28), -kr_cospi(CB, 36)>(t320, t315);
  const int t369 = kr_btf<CB, kr_cospi(CB, 60), -kr_cospi(CB, 4)>(t321, t314);
  const int t370 = add32(t278, t322);
  const int t371 = sub32(t278, t322);
  const int t372 = sub32(t281, t323);
  const int t373 = add32(t281, t323);
  const int t374 = add32(t282, t324);
  const int t375 = sub32(t282, t324);
  const int t376 = sub32(t285, t325);
  const int t377 = add32(t285, t325);
  const int t378 = add32(t286, t326);
  const int t379 = sub32(t286, t326);
  const int t380 = sub32(t289, t327);
  const int t381 = add32(t289, t327);
  const int t382 = add32(t290, t328);
  const int t383 = sub32(t290, t328);
  const int t384 = sub32(t293, t329);
  const int t385 = add32(t293, t329);
  const int t386 = kr_btf<CB, -kr_cospi(CB, 4), kr_cospi(CB, 60)>(t331, t360);
  const int t387 = kr_btf<CB, -kr_cospi(CB, 60), -kr_cospi(CB, 4)>(t332, t359);
  const int t388 = kr_btf<CB, -kr_cospi(CB, 36), kr_cospi(CB, 28)>(t335, t356);
  const int t389 = kr_btf<CB, -kr_cospi(CB, 28), -kr_cospi(CB, 36)>(t336, t355);
  const int t390 = kr_btf<CB, -kr_cospi(CB, 20), kr_cospi(CB, 44)>(t339, t352);
  const int t391 = kr_btf<CB, -kr_cospi(CB, 44), -kr_cospi(CB, 20)>(t340, t351);
  const int t392 = kr_btf<CB, -kr_cospi(CB, 52), kr_cospi(CB, 12)>(t343, t348);
  const int t393 = kr_btf<CB, -kr_cospi(CB, 12), -kr_cospi(CB, 52)>(t344, t347);
  const int t394 = kr_btf<CB, kr_cospi(CB, 12), -kr_cospi(CB, 52)>(t347, t344);
  const int t395 = kr_btf<CB, kr_cospi(CB, 52), kr_cospi(CB, 12)>(t348, t343);
  const int t396 = kr_btf<CB, kr_cospi(CB, 44), -kr_cospi(CB, 20)>(t351, t340);
  const int t397 = kr_btf<CB, kr_cospi(CB, 20), kr_cospi(CB, 44)>(t352, t339);
  const int t398 = kr_btf<CB, kr_cospi(CB, 28), -kr_cospi(CB, 36)>(t355, t336);
  const int t399 = kr_btf<CB, kr_cospi(CB, 36), kr_cospi(CB, 28)>(t356, t335);
  const int t400 = kr_btf<CB, kr_cospi(CB, 60), -kr_cospi(CB, 4)>(t359, t332);
  const int t401 = kr_btf<CB, kr_cospi(CB, 4), kr_cospi(CB, 60)>(t360, t331);
  // stage 9
  const int t402 = kr_btf<CB, kr_cospi(CB, 62), kr_cospi(CB, 2)>(t370, t385);
  const int t403 = kr_btf<CB, kr_cospi(CB, 30), kr_cospi(CB, 34)>(t371, t384);
  const int t404 = kr_btf<CB, kr_cospi(CB, 46), kr_cospi(CB, 18)>(t372, t383);
  const int t405 = kr_btf<CB, kr_cospi(CB, 14), kr_cospi(CB, 50)>(t373, t382);
  const int t406 = kr_btf<CB, kr_cospi(CB, 54), kr_cospi(CB, 10)>(t374, t381);
  const int t407 = kr_btf<CB, kr_cospi(CB, 22), kr_cospi(CB, 42)>(t375, t380);
  const int t408 = kr_btf<CB, kr_cospi(CB, 38), kr_cospi(CB, 26)>(t376, t379);
  const int t409 = kr_btf<CB, kr_cospi(CB, 6), kr_cospi(CB, 58)>(t377, t378);
  const int t410 = kr_btf<CB, kr_cospi(CB, 6), -kr_cospi(CB, 58)>(t378, t377);
  const int t411 = kr_btf<CB, kr_cospi(CB, 38), -kr_cospi(CB, 26)>(t379, t376);
  const int t412 = kr_btf<CB, kr_cospi(CB, 22), -kr_cospi(CB, 42)>(t380, t375);
  const int t413 = kr_btf<CB, kr_cospi(CB, 54), -kr_cospi(CB, 10)>(t381, t374);
  const int t414 = kr_btf<CB, kr_cospi(CB, 14), -kr_cospi(CB, 50)>(t382, t373);
  const int t415 = kr_btf<CB, kr_cospi(CB, 46), -kr_cospi(CB, 18)>(t383, t372);
  const int t416 = kr_btf<CB, kr_cospi(CB, 30), -kr_cospi(CB, 34)>(t384, t371);
  const int t417 = kr_btf<CB, kr_cospi(CB, 62), -kr_cospi(CB, 2)>(t385, t370);
  const int t418 = add32(t330, t386);
  const int t419 = sub32(t330, t386);
  const int t420 = sub32(t333, t387);
  const int t421 = add32(t333, t387);
  const int t422 = add32(t334, t388);
  const int t423 = sub32(t334, t388);
  const int t424 = sub32(t337, t389);
  const int t425 = add32(t337, t389);
  const int t426 = add32(t338, t390);
  const int t427 = sub32(t338, t390);
  const int t428 = sub32(t341, t391);
  const int t429 = add32(t341, t391);
  const int t430 = add32(t342, t392);
  const int t431 = sub32(t342, t392);
  const int t432 = sub32(t345, t393);
  const int t433 = add32(t345, t393);
  const int t434 = add32(t346, t394);
  const int t435 = sub32(t346, t394);
  const int t436 = sub32(t349, t395);
  const int t437 = add32(t349, t395);
  const int t438 = add32(t350, t396);
  const int t439 = sub32(t350, t396);
  const int t440 = sub32(t353, t397);
  const int t441 = add32(t353, t397);
  const int t442 = add32(t354, t398);
  const int t443 = sub32(t354, t398);
  const int t444 = sub32(t357, t399);
  const int t445 = add32(t357, t399);
  const int t446 = add32(t358, t400);
  const int t447 = sub32(t358, t400);
  const int t448 = sub32(t361, t401);
  const int t449 = add32(t361, t401);
  // stage 10
  const int t450 = kr_btf<CB, kr_cospi(CB, 63), kr_cospi(CB, 1)>(t418, t449);
  const int t451 = kr_btf<CB, kr_cospi(CB, 31), kr_cospi(CB, 33)>(t419, t448);
  const int t452 = kr_btf<CB, kr_cospi(CB, 47), kr_cospi(CB, 17)>(t420, t447);
  const int t453 = kr_btf<CB, kr_cospi(CB, 15), kr_cospi(CB, 49)>(t421, t446);
  const int t454 = kr_btf<CB, kr_cospi(CB, 55), kr_cospi(CB, 9)>(t422, t445);
  const int t455 = kr_btf<CB, kr_cospi(CB, 23), kr_cospi(CB, 41)>(t423, t444);
  const int t456 = kr_btf<CB, kr_cospi(CB, 39), kr_cospi(CB, 25)>(t424, t443);
  const int t457 = kr_btf<CB, kr_cospi(CB, 7), kr_cospi(CB, 57)>(t425, t442);
  const int t458 = kr_btf<CB, kr_cospi(CB, 59), kr_cospi(CB, 5)>(t426, t441);
  const int t459 = kr_btf<CB, kr_cospi(CB, 27), kr_cospi(CB, 37)>(t427, t440);
  const int t460 = kr_btf<CB, kr_cospi(CB, 43), kr_cospi(CB, 21)>(t428, t439);
  const int t461 = kr_btf<CB, kr_cospi(CB, 11), kr_cospi(CB, 53)>(t429, t438);
  const int t462 = kr_btf<CB, kr_cospi(CB, 51), kr_cospi(CB, 13)>(t430, t437);
  const int t463 = kr_btf<CB, kr_cospi(CB, 19), kr_cospi(CB, 45)>(t431, t436);
  const int t464 = kr_btf<CB, kr_cospi(CB, 35), kr_cospi(CB, 29)>(t432, t435);
  const int t465 = kr_btf<CB, kr_cospi(CB, 3), kr_cospi(CB, 61)>(t433, t434);
  const int t466 = kr_btf<CB, kr_cospi(CB, 3), -kr_cospi(CB, 61)>(t434, t433);
  const int t467 = kr_btf<CB, kr_cospi(CB, 35), -kr_cospi(CB, 29)>(t435, t432);
  const int t468 = kr_btf<CB, kr_cospi(CB, 19), -kr_cospi(CB, 45)>(t436, t431);
  const int t469 = kr_btf<CB, kr_cospi(CB, 51), -kr_cospi(CB, 13)>(t437, t430);
  const int t470 = kr_btf<CB, kr_cospi(CB, 11), -kr_cospi(CB, 53)>(t438, t429);
  const int t471 = kr_btf<CB, kr_cospi(CB, 43), -kr_cospi(CB, 21)>(t439, t428);
  const int t472 = kr_btf<CB, kr_cospi(CB, 27), -kr_cospi(CB, 37)>(t440, t427);
  const int t473 = kr_btf<CB, kr_cospi(CB, 59), -kr_cospi(CB, 5)>(t441, t426);
  const int t474 = kr_btf<CB, kr_cospi(CB, 7), -kr_cospi(CB, 57)>(t442, t425);
  const int t475 = kr_btf<CB, kr_cospi(CB, 39), -kr_cospi(CB, 25)>(t443, t424);
  const int t476 = kr_btf<CB, kr_cospi(CB, 23), -kr_cospi(CB, 41)>(t444, t423);
  const int t477 = kr_btf<CB, kr_cospi(CB, 55), -kr_cospi(CB, 9)>(t445, t422);
  const int t478 = kr_btf<CB, kr_cospi(CB, 15), -kr_cospi(CB, 49)>(t446, t421);
  const int t479 = kr_btf<CB, kr_cospi(CB, 47), -kr_cospi(CB, 17)>(t447, t420);
  const int t480 = kr_btf<CB, kr_cospi(CB, 31), -kr_cospi(CB, 33)>(t448, t419);
  const int t481 = kr_btf<CB, kr_cospi(CB, 63), -kr_cospi(CB, 1)>(t449, t418);
  // stage 11
  x[0] = t266;
  x[1] = t450;
  x[2] = t402;
  x[3] = t466;
  x[4] = t362;
  x[5] = t458;
  x[6] = t410;
  x[7] = t474;
  x[8] = t310;
  x[9] = t454;
  x[10] = t406;
  x[11] = t470;
  x[12] = t366;
  x[13] = t462;
  x[14] = t414;
  x[15] = t478;
  x[16] = t268;
  x[17] = t452;
  x[18] = t404;
  x[19] = t468;
  x[20] = t364;
  x[21] = t460;
  x[22] = t412;
  x[23] = t476;
  x[24] = t312;
  x[25] = t456;
  x[26] = t408;
  x[27] = t472;
  x[28] = t368;
  x[29] = t464;
  x[30] = t416;
  x[31] = t480;
  x[32] = t267;
  x[33] = t451;
  x[34] = t403;
  x[35] = t467;
  x[36] = t363;
  x[37] = t459;
  x[38] = t411;
  x[39] = t475;
  x[40] = t311;
  x[41] = t455;
  x[42] = t407;
  x[43] = t471;
  x[44] = t367;
  x[45] = t463;
  x[46] = t415;
  x[47] = t479;
  x[48] = t269;
  x[49] = t453;
  x[50] = t405;
  x[51] = t469;
  x[52] = t365;
  x[53] = t461;
  x[54] = t413;
  x[55] = t477;
  x[56] = t313;
  x[57] = t457;
  x[58] = t409;
  x[59] = t473;
  x[60] = t369;
  x[61] = t465;
  x[62] = t417;
  x[63] = t481;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_fadst8(int (&x)[8], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  const int x4 = x[4];
  const int x5 = x[5];
  const int x6 = x[6];
  const int x7 = x[7];
  // stage 1
  const int t0 = sub32(0, x7);
  const int t1 = sub32(0, x3);
  const int t2 = sub32(0, x1);
  const int t3 = sub32(0, x5);
  // stage 2
  const int t4 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t1, x4);
  const int t5 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(t1, x4);
  const int t6 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(x2, t3);
  const int t7 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(x2, t3);
  // stage 3
  const int t8 = add32(x0, t4);
  const int t9 = add32(t0, t5);
  const int t10 = sub32(x0, t4);
  const int t11 = sub32(t0, t5);
  const int t12 = add32(t2, t6);
  const int t13 = add32(x6, t7);
  const int t14 = sub32(t2, t6);
  const int t15 = sub32(x6, t7);
  // stage 4
  const int t16 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t12, t13);
  const int t17 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t12, t13);
  const int t18 = kr_btf<CB, -kr_cospi(CB, 48), kr_cospi(CB, 16)>(t14, t15);
  const int t19 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t14, t15);
  // stage 5
  const int t20 = add32(t8, t16);
  const int t21 = add32(t9, t17);
  const int t22 = add32(t10, t18);
  const int t23 = add32(t11, t19);
  const int t24 = sub32(t8, t16);
  const int t25 = sub32(t9, t17);
  const int t26 = sub32(t10, t18);
  const int t27 = sub32(t11, t19);
  // stage 6
  const int t28 = kr_btf<CB, kr_cospi(CB, 4), kr_cospi(CB, 60)>(t20, t21);
  const int t29 = kr_btf<CB, kr_cospi(CB, 60), -kr_cospi(CB, 4)>(t20, t21);
  const int t30 = kr_btf<CB, kr_cospi(CB, 20), kr_cospi(CB, 44)>(t22, t23);
  const int t31 = kr_btf<CB, kr_cospi(CB, 44), -kr_cospi(CB, 20)>(t22, t23);
  const int t32 = kr_btf<CB, kr_cospi(CB, 36), kr_cospi(CB, 28)>(t24, t25);
  const int t33 = kr_btf<CB, kr_cospi(CB, 28), -kr_cospi(CB, 36)>(t24, t25);
  const int t34 = kr_btf<CB, kr_cospi(CB, 52), kr_cospi(CB, 12)>(t26, t27);
  const int t35 = kr_btf<CB, kr_cospi(CB, 12), -kr_cospi(CB, 52)>(t26, t27);
  // stage 7
  x[0] = t29;
  x[1] = t34;
  x[2] = t31;
  x[3] = t32;
  x[4] = t33;
  x[5] = t30;
  x[6] = t35;
  x[7] = t28;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_fadst16(int (&x)[16], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  const int x4 = x[4];
  const int x5 = x[5];
  const int x6 = x[6];
  const int x7 = x[7];
  const int x8 = x[8];
  const int x9 = x[9];
  const int x10 = x[10];
  const int x11 = x[11];
  const int x12 = x[12];
  const int x13 = x[13];
  const int x14 = x[14];
  const int x15 = x[15];
  // stage 1
  const int t0 = sub32(0, x15);
  const int t1 = sub32(0, x7);
  const int t2 = sub32(0, x3);
  const int t3 = sub32(0, x11);
  const int t4 = sub32(0, x1);
  const int t5 = sub32(0, x9);
  const int t6 = sub32(0, x13);
  const int t7 = sub32(0, x5);
  // stage 2
  const int t8 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t1, x8);
  const int t9 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(t1, x8);
  const int t10 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(x4, t3);
  const int t11 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(x4, t3);
  const int t12 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(x6, t5);
  const int t13 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(x6, t5);
  const int t14 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t7, x10);
  const int t15 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(t7, x10);
  // stage 3
  const int t16 = add32(x0, t8);
  const int t17 = add32(t0, t9);
  const int t18 = sub32(x0, t8);
  const int t19 = sub32(t0, t9);
  const int t20 = add32(t2, t10);
  const int t21 = add32(x12, t11);
  const int t22 = sub32(t2, t10);
  const int t23 = sub32(x12, t11);
  const int t24 = add32(t4, t12);
  const int t25 = add32(x14, t13);
  const int t26 = sub32(t4, t12);
  const int t27 = sub32(x14, t13);
  const int t28 = add32(x2, t14);
  const int t29 = add32(t6, t15);
  const int t30 = sub32(x2, t14);
  const int t31 = sub32(t6, t15);
  // stage 4
  const int t32 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t20, t21);
  const int t33 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t20, t21);
  const int t34 = kr_btf<CB, -kr_cospi(CB, 48), kr_cospi(CB, 16)>(t22, t23);
  const int t35 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t22, t23);
  const int t36 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t28, t29);
  const int t37 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t28, t29);
  const int t38 = kr_btf<CB, -kr_cospi(CB, 48), kr_cospi(CB, 16)>(t30, t31);
  const int t39 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t30, t31);
  // stage 5
  const int t40 = add32(t16, t32);
  const int t41 = add32(t17, t33);
  const int t42 = add32(t18, t34);
  const int t43 = add32(t19, t35);
  const int t44 = sub32(t16, t32);
  const int t45 = sub32(t17, t33);
  const int t46 = sub32(t18, t34);
  const int t47 = sub32(t19, t35);
  const int t48 = add32(t24, t36);
  const int t49 = add32(t25, t37);
  const int t50 = add32(t26, t38);
  const int t51 = add32(t27, t39);
  const int t52 = sub32(t24, t36);
  const int t53 = sub32(t25, t37);
  const int t54 = sub32(t26, t38);
  const int t55 = sub32(t27, t39);
  // stage 6
  const int t56 = kr_btf<CB, kr_cospi(CB, 8), kr_cospi(CB, 56)>(t48, t49);
  const int t57 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t48, t49);
  const int t58 = kr_btf<CB, kr_cospi(CB, 40), kr_cospi(CB, 24)>(t50, t51);
  const int t59 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t50, t51);
  const int t60 = kr_btf<CB, -kr_cospi(CB, 56), kr_cospi(CB, 8)>(t52, t53);
  const int t61 = kr_btf<CB, kr_cospi(CB, 8), kr_cospi(CB, 56)>(t52, t53);
  const int t62 = kr_btf<CB, -kr_cospi(CB, 24), kr_cospi(CB, 40)>(t54, t55);
  const int t63 = kr_btf<CB, kr_cospi(CB, 40), kr_cospi(CB, 24)>(t54, t55);
  // stage 7
  const int t64 = add32(t40, t56);
  const int t65 = add32(t41, t57);
  const int t66 = add32(t42, t58);
  const int t67 = add32(t43, t59);
  const int t68 = add32(t44, t60);
  const int t69 = add32(t45, t61);
  const int t70 = add32(t46, t62);
  const int t71 = add32(t47, t63);
  const int t72 = sub32(t40, t56);
  const int t73 = sub32(t41, t57);
  const int t74 = sub32(t42, t58);
  const int t75 = sub32(t43, t59);
  const int t76 = sub32(t44, t60);
  const int t77 = sub32(t45, t61);
  const int t78 = sub32(t46, t62);
  const int t79 = sub32(t47, t63);
  // stage 8
  const int t80 = kr_btf<CB, kr_cospi(CB, 2), kr_cospi(CB, 62)>(t64, t65);
  const int t81 = kr_btf<CB, kr_cospi(CB, 62), -kr_cospi(CB, 2)>(t64, t65);
  const int t82 = kr_btf<CB, kr_cospi(CB, 10), kr_cospi(CB, 54)>(t66, t67);
  const int t83 = kr_btf<CB, kr_cospi(CB, 54), -kr_cospi(CB, 10)>(t66, t67);
  const int t84 = kr_btf<CB, kr_cospi(CB, 18), kr_cospi(CB, 46)>(t68, t69);
  const int t85 = kr_btf<CB, kr_cospi(CB, 46), -kr_cospi(CB, 18)>(t68, t69);
  const int t86 = kr_btf<CB, kr_cospi(CB, 26), kr_cospi(CB, 38)>(t70, t71);
  const int t87 = kr_btf<CB, kr_cospi(CB, 38), -kr_cospi(CB, 26)>(t70, t71);
  const int t88 = kr_btf<CB, kr_cospi(CB, 34), kr_cospi(CB, 30)>(t72, t73);
  const int t89 = kr_btf<CB, kr_cospi(CB, 30), -kr_cospi(CB, 34)>(t72, t73);
  const int t90 = kr_btf<CB, kr_cospi(CB, 42), kr_cospi(CB, 22)>(t74, t75);
  const int t91 = kr_btf<CB, kr_cospi(CB, 22), -kr_cospi(CB, 42)>(t74, t75);
  const int t92 = kr_btf<CB, kr_cospi(CB, 50), kr_cospi(CB, 14)>(t76, t77);
  const int t93 = kr_btf<CB, kr_cospi(CB, 14), -kr_cospi(CB, 50)>(t76, t77);
  const int t94 = kr_btf<CB, kr_cospi(CB, 58), kr_cospi(CB, 6)>(t78, t79);
  const int t95 = kr_btf<CB, kr_cospi(CB, 6), -kr_cospi(CB, 58)>(t78, t79);
  // stage 9
  x[0] = t81;
  x[1] = t94;
  x[2] = t83;
  x[3] = t92;
  x[4] = t85;
  x[5] = t90;
  x[6] = t87;
  x[7] = t88;
  x[8] = t89;
  x[9] = t86;
  x[10] = t91;
  x[11] = t84;
  x[12] = t93;
  x[13] = t82;
  x[14] = t95;
  x[15] = t80;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_idct4(int (&x)[4], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  // stage 1
  // stage 2
  const int t0 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(x0, x2);
  const int t1 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(x0, x2);
  const int t2 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(x1, x3);
  const int t3 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(x1, x3);
  // stage 3
  const int t4 = kr_clamp<CLAMP>(add32(t0, t3), lo, hi);
  const int t5 = kr_clamp<CLAMP>(add32(t1, t2), lo, hi);
  const int t6 = kr_clamp<CLAMP>(sub32(t1, t2), lo, hi);
  const int t7 = kr_clamp<CLAMP>(sub32(t0, t3), lo, hi);
  x[0] = t4;
  x[1] = t5;
  x[2] = t6;
  x[3] = t7;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_idct8(int (&x)[8], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  const int x4 = x[4];
  const int x5 = x[5];
  const int x6 = x[6];
  const int x7 = x[7];
  // stage 1
  // stage 2
  const int t0 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(x1, x7);
  const int t1 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(x5, x3);
  const int t2 = kr_btf<CB, kr_cospi(CB, 40), kr_cospi(CB, 24)>(x5, x3);
  const int t3 = kr_btf<CB, kr_cospi(CB, 8), kr_cospi(CB, 56)>(x1, x7);
  // stage 3
  const int t4 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(x0, x4);
  const int t5 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(x0, x4);
  const int t6 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(x2, x6);
  const int t7 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(x2, x6);
  const int t8 = kr_clamp<CLAMP>(add32(t0, t1), lo, hi);
  const int t9 = kr_clamp<CLAMP>(sub32(t0, t1), lo, hi);
  const int t10 = kr_clamp<CLAMP>(sub32(t3, t2), lo, hi);
  const int t11 = kr_clamp<CLAMP>(add32(t2, t3), lo, hi);
  // stage 4
  const int t12 = kr_clamp<CLAMP>(add32(t4, t7), lo, hi);
  const int t13 = kr_clamp<CLAMP>(add32(t5, t6), lo, hi);
  const int t14 = kr_clamp<CLAMP>(sub32(t5, t6), lo, hi);
  const int t15 = kr_clamp<CLAMP>(sub32(t4, t7), lo, hi);
  const int t16 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t9, t10);
  const int t17 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t9, t10);
  // stage 5
  const int t18 = kr_clamp<CLAMP>(add32(t12, t11), lo, hi);
  const int t19 = kr_clamp<CLAMP>(add32(t13, t17), lo, hi);
  const int t20 = kr_clamp<CLAMP>(add32(t14, t16), lo, hi);
  const int t21 = kr_clamp<CLAMP>(add32(t15, t8), lo, hi);
  const int t22 = kr_clamp<CLAMP>(sub32(t15, t8), lo, hi);
  const int t23 = kr_clamp<CLAMP>(sub32(t14, t16), lo, hi);
  const int t24 = kr_clamp<CLAMP>(sub32(t13, t17), lo, hi);
  const int t25 = kr_clamp<CLAMP>(sub32(t12, t11), lo, hi);
  x[0] = t18;
  x[1] = t19;
  x[2] = t20;
  x[3] = t21;
  x[4] = t22;
  x[5] = t23;
  x[6] = t24;
  x[7] = t25;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_idct16(int (&x)[16], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  const int x4 = x[4];
  const int x5 = x[5];
  const int x6 = x[6];
  const int x7 = x[7];
  const int x8 = x[8];
  const int x9 = x[9];
  const int x10 = x[10];
  const int x11 = x[11];
  const int x12 = x[12];
  const int x13 = x[13];
  const int x14 = x[14];
  const int x15 = x[15];
  // stage 1
  // stage 2
  const int t0 = kr_btf<CB, kr_cospi(CB, 60), -kr_cospi(CB, 4)>(x1, x15);
  const int t1 = kr_btf<CB, kr_cospi(CB, 28), -kr_cospi(CB, 36)>(x9, x7);
  const int t2 = kr_btf<CB, kr_cospi(CB, 44), -kr_cospi(CB, 20)>(x5, x11);
  const int t3 = kr_btf<CB, kr_cospi(CB, 12), -kr_cospi(CB, 52)>(x13, x3);
  const int t4 = kr_btf<CB, kr_cospi(CB, 52), kr_cospi(CB, 12)>(x13, x3);
  const int t5 = kr_btf<CB, kr_cospi(CB, 20), kr_cospi(CB, 44)>(x5, x11);
  const int t6 = kr_btf<CB, kr_cospi(CB, 36), kr_cospi(CB, 28)>(x9, x7);
  const int t7 = kr_btf<CB, kr_cospi(CB, 4), kr_cospi(CB, 60)>(x1, x15);
  // stage 3
  const int t8 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(x2, x14);
  const int t9 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(x10, x6);
  const int t10 = kr_btf<CB, kr_cospi(CB, 40), kr_cospi(CB, 24)>(x10, x6);
  const int t11 = kr_btf<CB, kr_cospi(CB, 8), kr_cospi(CB, 56)>(x2, x14);
  const int t12 = kr_clamp<CLAMP>(add32(t0, t1), lo, hi);
  const int t13 = kr_clamp<CLAMP>(sub32(t0, t1), lo, hi);
  const int t14 = kr_clamp<CLAMP>(sub32(t3, t2), lo, hi);
  const int t15 = kr_clamp<CLAMP>(add32(t2, t3), lo, hi);
  const int t16 = kr_clamp<CLAMP>(add32(t4, t5), lo, hi);
  const int t17 = kr_clamp<CLAMP>(sub32(t4, t5), lo, hi);
  const int t18 = kr_clamp<CLAMP>(sub32(t7, t6), lo, hi);
  const int t19 = kr_clamp<CLAMP>(add32(t6, t7), lo, hi);
  // stage 4
  const int t20 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(x0, x8);
  const int t21 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(x0, x8);
  const int t22 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(x4, x12);
  const int t23 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(x4, x12);
  const int t24 = kr_clamp<CLAMP>(add32(t8, t9), lo, hi);
  const int t25 = kr_clamp<CLAMP>(sub32(t8, t9), lo, hi);
  const int t26 = kr_clamp<CLAMP>(sub32(t11, t10), lo, hi);
  const int t27 = kr_clamp<CLAMP>(add32(t10, t11), lo, hi);
  const int t28 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t13, t18);
  const int t29 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t14, t17);
  const int t30 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t14, t17);
  const int t31 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t13, t18);
  // stage 5
  const int t32 = kr_clamp<CLAMP>(add32(t20, t23), lo, hi);
  const int t33 = kr_clamp<CLAMP>(add32(t21, t22), lo, hi);
  const int t34 = kr_clamp<CLAMP>(sub32(t21, t22), lo, hi);
  const int t35 = kr_clamp<CLAMP>(sub32(t20, t23), lo, hi);
  const int t36 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t25, t26);
  const int t37 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t25, t26);
  const int t38 = kr_clamp<CLAMP>(add32(t12, t15), lo, hi);
  const int t39 = kr_clamp<CLAMP>(add32(t28, t29), lo, hi);
  const int t40 = kr_clamp<CLAMP>(sub32(t28, t29), lo, hi);
  const int t41 = kr_clamp<CLAMP>(sub32(t12, t15), lo, hi);
  const int t42 = kr_clamp<CLAMP>(sub32(t19, t16), lo, hi);
  const int t43 = kr_clamp<CLAMP>(sub32(t31, t30), lo, hi);
  const int t44 = kr_clamp<CLAMP>(add32(t30, t31), lo, hi);
  const int t45 = kr_clamp<CLAMP>(add32(t16, t19), lo, hi);
  // stage 6
  const int t46 = kr_clamp<CLAMP>(add32(t32, t27), lo, hi);
  const int t47 = kr_clamp<CLAMP>(add32(t33, t37), lo, hi);
  const int t48 = kr_clamp<CLAMP>(add32(t34, t36), lo, hi);
  const int t49 = kr_clamp<CLAMP>(add32(t35, t24), lo, hi);
  const int t50 = kr_clamp<CLAMP>(sub32(t35, t24), lo, hi);
  const int t51 = kr_clamp<CLAMP>(sub32(t34, t36), lo, hi);
  const int t52 = kr_clamp<CLAMP>(sub32(t33, t37), lo, hi);
  const int t53 = kr_clamp<CLAMP>(sub32(t32, t27), lo, hi);
  const int t54 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t40, t43);
  const int t55 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t41, t42);
  const int t56 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t41, t42);
  const int t57 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t40, t43);
  // stage 7
  const int t58 = kr_clamp<CLAMP>(add32(t46, t45), lo, hi);
  const int t59 = kr_clamp<CLAMP>(add32(t47, t44), lo, hi);
  const int t60 = kr_clamp<CLAMP>(add32(t48, t57), lo, hi);
  const int t61 = kr_clamp<CLAMP>(add32(t49, t56), lo, hi);
  const int t62 = kr_clamp<CLAMP>(add32(t50, t55), lo, hi);
  const int t63 = kr_clamp<CLAMP>(add32(t51, t54), lo, hi);
  const int t64 = kr_clamp<CLAMP>(add32(t52, t39), lo, hi);
  const int t65 = kr_clamp<CLAMP>(add32(t53, t38), lo, hi);
  const int t66 = kr_clamp<CLAMP>(sub32(t53, t38), lo, hi);
  const int t67 = kr_clamp<CLAMP>(sub32(t52, t39), lo, hi);
  const int t68 = kr_clamp<CLAMP>(sub32(t51, t54), lo, hi);
  const int t69 = kr_clamp<CLAMP>(sub32(t50, t55), lo, hi);
  const int t70 = kr_clamp<CLAMP>(sub32(t49, t56), lo, hi);
  const int t71 = kr_clamp<CLAMP>(sub32(t48, t57), lo, hi);
  const int t72 = kr_clamp<CLAMP>(sub32(t47, t44), lo, hi);
  const int t73 = kr_clamp<CLAMP>(sub32(t46, t45), lo, hi);
  x[0] = t58;
  x[1] = t59;
  x[2] = t60;
  x[3] = t61;
  x[4] = t62;
  x[5] = t63;
  x[6] = t64;
  x[7] = t65;
  x[8] = t66;
  x[9] = t67;
  x[10] = t68;
  x[11] = t69;
  x[12] = t70;
  x[13] = t71;
  x[14] = t72;
  x[15] = t73;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_idct32(int (&x)[32], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  const int x4 = x[4];
  const int x5 = x[5];
  const int x6 = x[6];
  const int x7 = x[7];
  const int x8 = x[8];
  const int x9 = x[9];
  const int x10 = x[10];
  const int x11 = x[11];
  const int x12 = x[12];
  const int x13 = x[13];
  const int x14 = x[14];
  const int x15 = x[15];
  const int x16 = x[16];
  const int x17 = x[17];
  const int x18 = x[18];
  const int x19 = x[19];
  const int x20 = x[20];
  const int x21 = x[21];
  const int x22 = x[22];
  const int x23 = x[23];
  const int x24 = x[24];
  const int x25 = x[25];
  const int x26 = x[26];
  const int x27 = x[27];
  const int x28 = x[28];
  const int x29 = x[29];
  const int x30 = x[30];
  const int x31 = x[31];
  // stage 1
  // stage 2
  const int t0 = kr_btf<CB, kr_cospi(CB, 62), -kr_cospi(CB, 2)>(x1, x31);
  const int t1 = kr_btf<CB, kr_cospi(CB, 30), -kr_cospi(CB, 34)>(x17, x15);
  const int t2 = kr_btf<CB, kr_cospi(CB, 46), -kr_cospi(CB, 18)>(x9, x23);
  const int t3 = kr_btf<CB, kr_cospi(CB, 14), -kr_cospi(CB, 50)>(x25, x7);
  const int t4 = kr_btf<CB, kr_cospi(CB, 54), -kr_cospi(CB, 10)>(x5, x27);
  const int t5 = kr_btf<CB, kr_cospi(CB, 22), -kr_cospi(CB, 42)>(x21, x11);
  const int t6 = kr_btf<CB, kr_cospi(CB, 38), -kr_cospi(CB, 26)>(x13, x19);
  const int t7 = kr_btf<CB, kr_cospi(CB, 6), -kr_cospi(CB, 58)>(x29, x3);
  const int t8 = kr_btf<CB, kr_cospi(CB, 58), kr_cospi(CB, 6)>(x29, x3);
  const int t9 = kr_btf<CB, kr_cospi(CB, 26), kr_cospi(CB, 38)>(x13, x19);
  const int t10 = kr_btf<CB, kr_cospi(CB, 42), kr_cospi(CB, 22)>(x21, x11);
  const int t11 = kr_btf<CB, kr_cospi(CB, 10), kr_cospi(CB, 54)>(x5, x27);
  const int t12 = kr_btf<CB, kr_cospi(CB, 50), kr_cospi(CB, 14)>(x25, x7);
  const int t13 = kr_btf<CB, kr_cospi(CB, 18), kr_cospi(CB, 46)>(x9, x23);
  const int t14 = kr_btf<CB, kr_cospi(CB, 34), kr_cospi(CB, 30)>(x17, x15);
  const int t15 = kr_btf<CB, kr_cospi(CB, 2), kr_cospi(CB, 62)>(x1, x31);
  // stage 3
  const int t16 = kr_btf<CB, kr_cospi(CB, 60), -kr_cospi(CB, 4)>(x2, x30);
  const int t17 = kr_btf<CB, kr_cospi(CB, 28), -kr_cospi(CB, 36)>(x18, x14);
  const int t18 = kr_btf<CB, kr_cospi(CB, 44), -kr_cospi(CB, 20)>(x10, x22);
  const int t19 = kr_btf<CB, kr_cospi(CB, 12), -kr_cospi(CB, 52)>(x26, x6);
  const int t20 = kr_btf<CB, kr_cospi(CB, 52), kr_cospi(CB, 12)>(x26, x6);
  const int t21 = kr_btf<CB, kr_cospi(CB, 20), kr_cospi(CB, 44)>(x10, x22);
  const int t22 = kr_btf<CB, kr_cospi(CB, 36), kr_cospi(CB, 28)>(x18, x14);
  const int t23 = kr_btf<CB, kr_cospi(CB, 4), kr_cospi(CB, 60)>(x2, x30);
  const int t24 = kr_clamp<CLAMP>(add32(t0, t1), lo, hi);
  const int t25 = kr_clamp<CLAMP>(sub32(t0, t1), lo, hi);
  const int t26 = kr_clamp<CLAMP>(sub32(t3, t2), lo, hi);
  const int t27 = kr_clamp<CLAMP>(add32(t2, t3), lo, hi);
  const int t28 = kr_clamp<CLAMP>(add32(t4, t5), lo, hi);
  const int t29 = kr_clamp<CLAMP>(sub32(t4, t5), lo, hi);
  const int t30 = kr_clamp<CLAMP>(sub32(t7, t6), lo, hi);
  const int t31 = kr_clamp<CLAMP>(add32(t6, t7), lo, hi);
  const int t32 = kr_clamp<CLAMP>(add32(t8, t9), lo, hi);
  const int t33 = kr_clamp<CLAMP>(sub32(t8, t9), lo, hi);
  const int t34 = kr_clamp<CLAMP>(sub32(t11, t10), lo, hi);
  const int t35 = kr_clamp<CLAMP>(add32(t10, t11), lo, hi);
  const int t36 = kr_clamp<CLAMP>(add32(t12, t13), lo, hi);
  const int t37 = kr_clamp<CLAMP>(sub32(t12, t13), lo, hi);
  const int t38 = kr_clamp<CLAMP>(sub32(t15, t14), lo, hi);
  const int t39 = kr_clamp<CLAMP>(add32(t14, t15), lo, hi);
  // stage 4
  const int t40 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(x4, x28);
  const int t41 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(x20, x12);
  const int t42 = kr_btf<CB, kr_cospi(CB, 40), kr_cospi(CB, 24)>(x20, x12);
  const int t43 = kr_btf<CB, kr_cospi(CB, 8), kr_cospi(CB, 56)>(x4, x28);
  const int t44 = kr_clamp<CLAMP>(add32(t16, t17), lo, hi);
  const int t45 = kr_clamp<CLAMP>(sub32(t16, t17), lo, hi);
  const int t46 = kr_clamp<CLAMP>(sub32(t19, t18), lo, hi);
  const int t47 = kr_clamp<CLAMP>(add32(t18, t19), lo, hi);
  const int t48 = kr_clamp<CLAMP>(add32(t20, t21), lo, hi);
  const int t49 = kr_clamp<CLAMP>(sub32(t20, t21), lo, hi);
  const int t50 = kr_clamp<CLAMP>(sub32(t23, t22), lo, hi);
  const int t51 = kr_clamp<CLAMP>(add32(t22, t23), lo, hi);
  const int t52 = kr_btf<CB, -kr_cospi(CB, 8), kr_cospi(CB, 56)>(t25, t38);
  const int t53 = kr_btf<CB, -kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t26, t37);
  const int t54 = kr_btf<CB, -kr_cospi(CB, 40), kr_cospi(CB, 24)>(t29, t34);
  const int t55 = kr_btf<CB, -kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t30, t33);
  const int t56 = kr_btf<CB, -kr_cospi(CB, 40), kr_cospi(CB, 24)>(t30, t33);
  const int t57 = kr_btf<CB, kr_cospi(CB, 24), kr_cospi(CB, 40)>(t29, t34);
  const int t58 = kr_btf<CB, -kr_cospi(CB, 8), kr_cospi(CB, 56)>(t26, t37);
  const int t59 = kr_btf<CB, kr_cospi(CB, 56), kr_cospi(CB, 8)>(t25, t38);
  // stage 5
  const int t60 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(x0, x16);
  const int t61 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(x0, x16);
  const int t62 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(x8, x24);
  const int t63 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(x8, x24);
  const int t64 = kr_clamp<CLAMP>(add32(t40, t41), lo, hi);
  const int t65 = kr_clamp<CLAMP>(sub32(t40, t41), lo, hi);
  const int t66 = kr_clamp<CLAMP>(sub32(t43, t42), lo, hi);
  const int t67 = kr_clamp<CLAMP>(add32(t42, t43), lo, hi);
  const int t68 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t45, t50);
  const int t69 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t46, t49);
  const int t70 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t46, t49);
  const int t71 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t45, t50);
  const int t72 = kr_clamp<CLAMP>(add32(t24, t27), lo, hi);
  const int t73 = kr_clamp<CLAMP>(add32(t52, t53), lo, hi);
  const int t74 = kr_clamp<CLAMP>(sub32(t52, t53), lo, hi);
  const int t75 = kr_clamp<CLAMP>(sub32(t24, t27), lo, hi);
  const int t76 = kr_clamp<CLAMP>(sub32(t31, t28), lo, hi);
  const int t77 = kr_clamp<CLAMP>(sub32(t55, t54), lo, hi);
  const int t78 = kr_clamp<CLAMP>(add32(t54, t55), lo, hi);
  const int t79 = kr_clamp<CLAMP>(add32(t28, t31), lo, hi);
  const int t80 = kr_clamp<CLAMP>(add32(t32, t35), lo, hi);
  const int t81 = kr_clamp<CLAMP>(add32(t56, t57), lo, hi);
  const int t82 = kr_clamp<CLAMP>(sub32(t56, t57), lo, hi);
  const int t83 = kr_clamp<CLAMP>(sub32(t32, t35), lo, hi);
  const int t84 = kr_clamp<CLAMP>(sub32(t39, t36), lo, hi);
  const int t85 = kr_clamp<CLAMP>(sub32(t59, t58), lo, hi);
  const int t86 = kr_clamp<CLAMP>(add32(t58, t59), lo, hi);
  const int t87 = kr_clamp<CLAMP>(add32(t36, t39), lo, hi);
  // stage 6
  const int t88 = kr_clamp<CLAMP>(add32(t60, t63), lo, hi);
  const int t89 = kr_clamp<CLAMP>(add32(t61, t62), lo, hi);
  const int t90 = kr_clamp<CLAMP>(sub32(t61, t62), lo, hi);
  const int t91 = kr_clamp<CLAMP>(sub32(t60, t63), lo, hi);
  const int t92 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t65, t66);
  const int t93 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t65, t66);
  const int t94 = kr_clamp<CLAMP>(add32(t44, t47), lo, hi);
  const int t95 = kr_clamp<CLAMP>(add32(t68, t69), lo, hi);
  const int t96 = kr_clamp<CLAMP>(sub32(t68, t69), lo, hi);
  const int t97 = kr_clamp<CLAMP>(sub32(t44, t47), lo, hi);
  const int t98 = kr_clamp<CLAMP>(sub32(t51, t48), lo, hi);
  const int t99 = kr_clamp<CLAMP>(sub32(t71, t70), lo, hi);
  const int t100 = kr_clamp<CLAMP>(add32(t70, t71), lo, hi);
  const int t101 = kr_clamp<CLAMP>(add32(t48, t51), lo, hi);
  const int t102 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t74, t85);
  const int t103 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t75, t84);
  const int t104 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t76, t83);
  const int t105 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t77, t82);
  const int t106 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t77, t82);
  const int t107 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t76, t83);
  const int t108 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t75, t84);
  const int t109 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t74, t85);
  // stage 7
  const int t110 = kr_clamp<CLAMP>(add32(t88, t67), lo, hi);
  const int t111 = kr_clamp<CLAMP>(add32(t89, t93), lo, hi);
  const int t112 = kr_clamp<CLAMP>(add32(t90, t92), lo, hi);
  const int t113 = kr_clamp<CLAMP>(add32(t91, t64), lo, hi);
  const int t114 = kr_clamp<CLAMP>(sub32(t91, t64), lo, hi);
  const int t115 = kr_clamp<CLAMP>(sub32(t90, t92), lo, hi);
  const int t116 = kr_clamp<CLAMP>(sub32(t89, t93), lo, hi);
  const int t117 = kr_clamp<CLAMP>(sub32(t88, t67), lo, hi);
  const int t118 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t96, t99);
  const int t119 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t97, t98);
  const int t120 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t97, t98);
  const int t121 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t96, t99);
  const int t122 = kr_clamp<CLAMP>(add32(t72, t79), lo, hi);
  const int t123 = kr_clamp<CLAMP>(add32(t73, t78), lo, hi);
  const int t124 = kr_clamp<CLAMP>(add32(t102, t105), lo, hi);
  const int t125 = kr_clamp<CLAMP>(add32(t103, t104), lo, hi);
  const int t126 = kr_clamp<CLAMP>(sub32(t103, t104), lo, hi);
  const int t127 = kr_clamp<CLAMP>(sub32(t102, t105), lo, hi);
  const int t128 = kr_clamp<CLAMP>(sub32(t73, t78), lo, hi);
  const int t129 = kr_clamp<CLAMP>(sub32(t72, t79), lo, hi);
  const int t130 = kr_clamp<CLAMP>(sub32(t87, t80), lo, hi);
  const int t131 = kr_clamp<CLAMP>(sub32(t86, t81), lo, hi);
  const int t132 = kr_clamp<CLAMP>(sub32(t109, t106), lo, hi);
  const int t133 = kr_clamp<CLAMP>(sub32(t108, t107), lo, hi);
  const int t134 = kr_clamp<CLAMP>(add32(t107, t108), lo, hi);
  const int t135 = kr_clamp<CLAMP>(add32(t106, t109), lo, hi);
  const int t136 = kr_clamp<CLAMP>(add32(t81, t86), lo, hi);
  const int t137 = kr_clamp<CLAMP>(add32(t80, t87), lo, hi);
  // stage 8
  const int t138 = kr_clamp<CLAMP>(add32(t110, t101), lo, hi);
  const int t139 = kr_clamp<CLAMP>(add32(t111, t100), lo, hi);
  const int t140 = kr_clamp<CLAMP>(add32(t112, t121), lo, hi);
  const int t141 = kr_clamp<CLAMP>(add32(t113, t120), lo, hi);
  const int t142 = kr_clamp<CLAMP>(add32(t114, t119), lo, hi);
  const int t143 = kr_clamp<CLAMP>(add32(t115, t118), lo, hi);
  const int t144 = kr_clamp<CLAMP>(add32(t116, t95), lo, hi);
  const int t145 = kr_clamp<CLAMP>(add32(t117, t94), lo, hi);
  const int t146 = kr_clamp<CLAMP>(sub32(t117, t94), lo, hi);
  const int t147 = kr_clamp<CLAMP>(sub32(t116, t95), lo, hi);
  const int t148 = kr_clamp<CLAMP>(sub32(t115, t118), lo, hi);
  const int t149 = kr_clamp<CLAMP>(sub32(t114, t119), lo, hi);
  const int t150 = kr_clamp<CLAMP>(sub32(t113, t120), lo, hi);
  const int t151 = kr_clamp<CLAMP>(sub32(t112, t121), lo, hi);
  const int t152 = kr_clamp<CLAMP>(sub32(t111, t100), lo, hi);
  const int t153 = kr_clamp<CLAMP>(sub32(t110, t101), lo, hi);
  const int t154 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t126, t133);
  const int t155 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t127, t132);
  const int t156 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t128, t131);
  const int t157 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t129, t130);
  const int t158 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t129, t130);
  const int t159 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t128, t131);
  const int t160 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t127, t132);
  const int t161 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t126, t133);
  // stage 9
  const int t162 = kr_clamp<CLAMP>(add32(t138, t137), lo, hi);
  const int t163 = kr_clamp<CLAMP>(add32(t139, t136), lo, hi);
  const int t164 = kr_clamp<CLAMP>(add32(t140, t135), lo, hi);
  const int t165 = kr_clamp<CLAMP>(add32(t141, t134), lo, hi);
  const int t166 = kr_clamp<CLAMP>(add32(t142, t161), lo, hi);
  const int t167 = kr_clamp<CLAMP>(add32(t143, t160), lo, hi);
  const int t168 = kr_clamp<CLAMP>(add32(t144, t159), lo, hi);
  const int t169 = kr_clamp<CLAMP>(add32(t145, t158), lo, hi);
  const int t170 = kr_clamp<CLAMP>(add32(t146, t157), lo, hi);
  const int t171 = kr_clamp<CLAMP>(add32(t147, t156), lo, hi);
  const int t172 = kr_clamp<CLAMP>(add32(t148, t155), lo, hi);
  const int t173 = kr_clamp<CLAMP>(add32(t149, t154), lo, hi);
  const int t174 = kr_clamp<CLAMP>(add32(t150, t125), lo, hi);
  const int t175 = kr_clamp<CLAMP>(add32(t151, t124), lo, hi);
  const int t176 = kr_clamp<CLAMP>(add32(t152, t123), lo, hi);
  const int t177 = kr_clamp<CLAMP>(add32(t153, t122), lo, hi);
  const int t178 = kr_clamp<CLAMP>(sub32(t153, t122), lo, hi);
  const int t179 = kr_clamp<CLAMP>(sub32(t152, t123), lo, hi);
  const int t180 = kr_clamp<CLAMP>(sub32(t151, t124), lo, hi);
  const int t181 = kr_clamp<CLAMP>(sub32(t150, t125), lo, hi);
  const int t182 = kr_clamp<CLAMP>(sub32(t149, t154), lo, hi);
  const int t183 = kr_clamp<CLAMP>(sub32(t148, t155), lo, hi);
  const int t184 = kr_clamp<CLAMP>(sub32(t147, t156), lo, hi);
  const int t185 = kr_clamp<CLAMP>(sub32(t146, t157), lo, hi);
  const int t186 = kr_clamp<CLAMP>(sub32(t145, t158), lo, hi);
  const int t187 = kr_clamp<CLAMP>(sub32(t144, t159), lo, hi);
  const int t188 = kr_clamp<CLAMP>(sub32(t143, t160), lo, hi);
  const int t189 = kr_clamp<CLAMP>(sub32(t142, t161), lo, hi);
  const int t190 = kr_clamp<CLAMP>(sub32(t141, t134), lo, hi);
  const int t191 = kr_clamp<CLAMP>(sub32(t140, t135), lo, hi);
  const int t192 = kr_clamp<CLAMP>(sub32(t139, t136), lo, hi);
  const int t193 = kr_clamp<CLAMP>(sub32(t138, t137), lo, hi);
  x[0] = t162;
  x[1] = t163;
  x[2] = t164;
  x[3] = t165;
  x[4] = t166;
  x[5] = t167;
  x[6] = t168;
  x[7] = t169;
  x[8] = t170;
  x[9] = t171;
  x[10] = t172;
  x[11] = t173;
  x[12] = t174;
  x[13] = t175;
  x[14] = t176;
  x[15] = t177;
  x[16] = t178;
  x[17] = t179;
  x[18] = t180;
  x[19] = t181;
  x[20] = t182;
  x[21] = t183;
  x[22] = t184;
  x[23] = t185;
  x[24] = t186;
  x[25] = t187;
  x[26] = t188;
  x[27] = t189;
  x[28] = t190;
  x[29] = t191;
  x[30] = t192;
  x[31] = t193;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_idct64(int (&x)[64], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  const int x4 = x[4];
  const int x5 = x[5];
  const int x6 = x[6];
  const int x7 = x[7];
  const int x8 = x[8];
  const int x9 = x[9];
  const int x10 = x[10];
  const int x11 = x[11];
  const int x12 = x[12];
  const int x13 = x[13];
  const int x14 = x[14];
  const int x15 = x[15];
  const int x16 = x[16];
  const int x17 = x[17];
  const int x18 = x[18];
  const int x19 = x[19];
  const int x20 = x[20];
  const int x21 = x[21];
  const int x22 = x[22];
  const int x23 = x[23];
  const int x24 = x[24];
  const int x25 = x[25];
  const int x26 = x[26];
  const int x27 = x[27];
  const int x28 = x[28];
  const int x29 = x[29];
  const int x30 = x[30];
  const int x31 = x[31];
  const int x32 = x[32];
  const int x33 = x[33];
  const int x34 = x[34];
  const int x35 = x[35];
  const int x36 = x[36];
  const int x37 = x[37];
  const int x38 = x[38];
  const int x39 = x[39];
  const int x40 = x[40];
  const int x41 = x[41];
  const int x42 = x[42];
  const int x43 = x[43];
  const int x44 = x[44];
  const int x45 = x[45];
  const int x46 = x[46];
  const int x47 = x[47];
  const int x48 = x[48];
  const int x49 = x[49];
  const int x50 = x[50];
  const int x51 = x[51];
  const int x52 = x[52];
  const int x53 = x[53];
  const int x54 = x[54];
  const int x55 = x[55];
  const int x56 = x[56];
  const int x57 = x[57];
  const int x58 = x[58];
  const int x59 = x[59];
  const int x60 = x[60];
  const int x61 = x[61];
  const int x62 = x[62];
  const int x63 = x[63];
  // stage 1
  // stage 2
  const int t0 = kr_btf<CB, kr_cospi(CB, 63), -kr_cospi(CB, 1)>(x1, x63);
  const int t1 = kr_btf<CB, kr_cospi(CB, 31), -kr_cospi(CB, 33)>(x33, x31);
  const int t2 = kr_btf<CB, kr_cospi(CB, 47), -kr_cospi(CB, 17)>(x17, x47);
  const int t3 = kr_btf<CB, kr_cospi(CB, 15), -kr_cospi(CB, 49)>(x49, x15);
  const int t4 = kr_btf<CB, kr_cospi(CB, 55), -kr_cospi(CB, 9)>(x9, x55);
  const int t5 = kr_btf<CB, kr_cospi(CB, 23), -kr_cospi(CB, 41)>(x41, x23);
  const int t6 = kr_btf<CB, kr_cospi(CB, 39), -kr_cospi(CB, 25)>(x25, x39);
  const int t7 = kr_btf<CB, kr_cospi(CB, 7), -kr_cospi(CB, 57)>(x57, x7);
  const int t8 = kr_btf<CB, kr_cospi(CB, 59), -kr_cospi(CB, 5)>(x5, x59);
  const int t9 = kr_btf<CB, kr_cospi(CB, 27), -kr_cospi(CB, 37)>(x37, x27);
  const int t10 = kr_btf<CB, kr_cospi(CB, 43), -kr_cospi(CB, 21)>(x21, x43);
  const int t11 = kr_btf<CB, kr_cospi(CB, 11), -kr_cospi(CB, 53)>(x53, x11);
  const int t12 = kr_btf<CB, kr_cospi(CB, 51), -kr_cospi(CB, 13)>(x13, x51);
  const int t13 = kr_btf<CB, kr_cospi(CB, 19), -kr_cospi(CB, 45)>(x45, x19);
  const int t14 = kr_btf<CB, kr_cospi(CB, 35), -kr_cospi(CB, 29)>(x29, x35);
  const int t15 = kr_btf<CB, kr_cospi(CB, 3), -kr_cospi(CB, 61)>(x61, x3);
  const int t16 = kr_btf<CB, kr_cospi(CB, 61), kr_cospi(CB, 3)>(x61, x3);
  const int t17 = kr_btf<CB, kr_cospi(CB, 29), kr_cospi(CB, 35)>(x29, x35);
  const int t18 = kr_btf<CB, kr_cospi(CB, 45), kr_cospi(CB, 19)>(x45, x19);
  const int t19 = kr_btf<CB, kr_cospi(CB, 13), kr_cospi(CB, 51)>(x13, x51);
  const int t20 = kr_btf<CB, kr_cospi(CB, 53), kr_cospi(CB, 11)>(x53, x11);
  const int t21 = kr_btf<CB, kr_cospi(CB, 21), kr_cospi(CB, 43)>(x21, x43);
  const int t22 = kr_btf<CB, kr_cospi(CB, 37), kr_cospi(CB, 27)>(x37, x27);
  const int t23 = kr_btf<CB, kr_cospi(CB, 5), kr_cospi(CB, 59)>(x5, x59);
  const int t24 = kr_btf<CB, kr_cospi(CB, 57), kr_cospi(CB, 7)>(x57, x7);
  const int t25 = kr_btf<CB, kr_cospi(CB, 25), kr_cospi(CB, 39)>(x25, x39);
  const int t26 = kr_btf<CB, kr_cospi(CB, 41), kr_cospi(CB, 23)>(x41, x23);
  const int t27 = kr_btf<CB, kr_cospi(CB, 9), kr_cospi(CB, 55)>(x9, x55);
  const int t28 = kr_btf<CB, kr_cospi(CB, 49), kr_cospi(CB, 15)>(x49, x15);
  const int t29 = kr_btf<CB, kr_cospi(CB, 17), kr_cospi(CB, 47)>(x17, x47);
  const int t30 = kr_btf<CB, kr_cospi(CB, 33), kr_cospi(CB, 31)>(x33, x31);
  const int t31 = kr_btf<CB, kr_cospi(CB, 1), kr_cospi(CB, 63)>(x1, x63);
  // stage 3
  const int t32 = kr_btf<CB, kr_cospi(CB, 62), -kr_cospi(CB, 2)>(x2, x62);
  const int t33 = kr_btf<CB, kr_cospi(CB, 30), -kr_cospi(CB, 34)>(x34, x30);
  const int t34 = kr_btf<CB, kr_cospi(CB, 46), -kr_cospi(CB, 18)>(x18, x46);
  const int t35 = kr_btf<CB, kr_cospi(CB, 14), -kr_cospi(CB, 50)>(x50, x14);
  const int t36 = kr_btf<CB, kr_cospi(CB, 54), -kr_cospi(CB, 10)>(x10, x54);
  const int t37 = kr_btf<CB, kr_cospi(CB, 22), -kr_cospi(CB, 42)>(x42, x22);
  const int t38 = kr_btf<CB, kr_cospi(CB, 38), -kr_cospi(CB, 26)>(x26, x38);
  const int t39 = kr_btf<CB, kr_cospi(CB, 6), -kr_cospi(CB, 58)>(x58, x6);
  const int t40 = kr_btf<CB, kr_cospi(CB, 58), kr_cospi(CB, 6)>(x58, x6);
  const int t41 = kr_btf<CB, kr_cospi(CB, 26), kr_cospi(CB, 38)>(x26, x38);
  const int t42 = kr_btf<CB, kr_cospi(CB, 42), kr_cospi(CB, 22)>(x42, x22);
  const int t43 = kr_btf<CB, kr_cospi(CB, 10), kr_cospi(CB, 54)>(x10, x54);
  const int t44 = kr_btf<CB, kr_cospi(CB, 50), kr_cospi(CB, 14)>(x50, x14);
  const int t45 = kr_btf<CB, kr_cospi(CB, 18), kr_cospi(CB, 46)>(x18, x46);
  const int t46 = kr_btf<CB, kr_cospi(CB, 34), kr_cospi(CB, 30)>(x34, x30);
  const int t47 = kr_btf<CB, kr_cospi(CB, 2), kr_cospi(CB, 62)>(x2, x62);
  const int t48 = kr_clamp<CLAMP>(add32(t0, t1), lo, hi);
  const int t49 = kr_clamp<CLAMP>(sub32(t0, t1), lo, hi);
  const int t50 = kr_clamp<CLAMP>(sub32(t3, t2), lo, hi);
  const int t51 = kr_clamp<CLAMP>(add32(t2, t3), lo, hi);
  const int t52 = kr_clamp<CLAMP>(add32(t4, t5), lo, hi);
  const int t53 = kr_clamp<CLAMP>(sub32(t4, t5), lo, hi);
  const int t54 = kr_clamp<CLAMP>(sub32(t7, t6), lo, hi);
  const int t55 = kr_clamp<CLAMP>(add32(t6, t7), lo, hi);
  const int t56 = kr_clamp<CLAMP>(add32(t8, t9), lo, hi);
  const int t57 = kr_clamp<CLAMP>(sub32(t8, t9), lo, hi);
  const int t58 = kr_clamp<CLAMP>(sub32(t11, t10), lo, hi);
  const int t59 = kr_clamp<CLAMP>(add32(t10, t11), lo, hi);
  const int t60 = kr_clamp<CLAMP>(add32(t12, t13), lo, hi);
  const int t61 = kr_clamp<CLAMP>(sub32(t12, t13), lo, hi);
  const int t62 = kr_clamp<CLAMP>(sub32(t15, t14), lo, hi);
  const int t63 = kr_clamp<CLAMP>(add32(t14, t15), lo, hi);
  const int t64 = kr_clamp<CLAMP>(add32(t16, t17), lo, hi);
  const int t65 = kr_clamp<CLAMP>(sub32(t16, t17), lo, hi);
  const int t66 = kr_clamp<CLAMP>(sub32(t19, t18), lo, hi);
  const int t67 = kr_clamp<CLAMP>(add32(t18, t19), lo, hi);
  const int t68 = kr_clamp<CLAMP>(add32(t20, t21), lo, hi);
  const int t69 = kr_clamp<CLAMP>(sub32(t20, t21), lo, hi);
  const int t70 = kr_clamp<CLAMP>(sub32(t23, t22), lo, hi);
  const int t71 = kr_clamp<CLAMP>(add32(t22, t23), lo, hi);
  const int t72 = kr_clamp<CLAMP>(add32(t24, t25), lo, hi);
  const int t73 = kr_clamp<CLAMP>(sub32(t24, t25), lo, hi);
  const int t74 = kr_clamp<CLAMP>(sub32(t27, t26), lo, hi);
  const int t75 = kr_clamp<CLAMP>(add32(t26, t27), lo, hi);
  const int t76 = kr_clamp<CLAMP>(add32(t28, t29), lo, hi);
  const int t77 = kr_clamp<CLAMP>(sub32(t28, t29), lo, hi);
  const int t78 = kr_clamp<CLAMP>(sub32(t31, t30), lo, hi);
  const int t79 = kr_clamp<CLAMP>(add32(t30, t31), lo, hi);
  // stage 4
  const int t80 = kr_btf<CB, kr_cospi(CB, 60), -kr_cospi(CB, 4)>(x4, x60);
  const int t81 = kr_btf<CB, kr_cospi(CB, 28), -kr_cospi(CB, 36)>(x36, x28);
  const int t82 = kr_btf<CB, kr_cospi(CB, 44), -kr_cospi(CB, 20)>(x20, x44);
  const int t83 = kr_btf<CB, kr_cospi(CB, 12), -kr_cospi(CB, 52)>(x52, x12);
  const int t84 = kr_btf<CB, kr_cospi(CB, 52), kr_cospi(CB, 12)>(x52, x12);
  const int t85 = kr_btf<CB, kr_cospi(CB, 20), kr_cospi(CB, 44)>(x20, x44);
  const int t86 = kr_btf<CB, kr_cospi(CB, 36), kr_cospi(CB, 28)>(x36, x28);
  const int t87 = kr_btf<CB, kr_cospi(CB, 4), kr_cospi(CB, 60)>(x4, x60);
  const int t88 = kr_clamp<CLAMP>(add32(t32, t33), lo, hi);
  const int t89 = kr_clamp<CLAMP>(sub32(t32, t33), lo, hi);
  const int t90 = kr_clamp<CLAMP>(sub32(t35, t34), lo, hi);
  const int t91 = kr_clamp<CLAMP>(add32(t34, t35), lo, hi);
  const int t92 = kr_clamp<CLAMP>(add32(t36, t37), lo, hi);
  const int t93 = kr_clamp<CLAMP>(sub32(t36, t37), lo, hi);
  const int t94 = kr_clamp<CLAMP>(sub32(t39, t38), lo, hi);
  const int t95 = kr_clamp<CLAMP>(add32(t38, t39), lo, hi);
  const int t96 = kr_clamp<CLAMP>(add32(t40, t41), lo, hi);
  const int t97 = kr_clamp<CLAMP>(sub32(t40, t41), lo, hi);
  const int t98 = kr_clamp<CLAMP>(sub32(t43, t42), lo, hi);
  const int t99 = kr_clamp<CLAMP>(add32(t42, t43), lo, hi);
  const int t100 = kr_clamp<CLAMP>(add32(t44, t45), lo, hi);
  const int t101 = kr_clamp<CLAMP>(sub32(t44, t45), lo, hi);
  const int t102 = kr_clamp<CLAMP>(sub32(t47, t46), lo, hi);
  const int t103 = kr_clamp<CLAMP>(add32(t46, t47), lo, hi);
  const int t104 = kr_btf<CB, -kr_cospi(CB, 4), kr_cospi(CB, 60)>(t49, t78);
  const int t105 = kr_btf<CB, -kr_cospi(CB, 60), -kr_cospi(CB, 4)>(t50, t77);
  const int t106 = kr_btf<CB, -kr_cospi(CB, 36), kr_cospi(CB, 28)>(t53, t74);
  const int t107 = kr_btf<CB, -kr_cospi(CB, 28), -kr_cospi(CB, 36)>(t54, t73);
  const int t108 = kr_btf<CB, -kr_cospi(CB, 20), kr_cospi(CB, 44)>(t57, t70);
  const int t109 = kr_btf<CB, -kr_cospi(CB, 44), -kr_cospi(CB, 20)>(t58, t69);
  const int t110 = kr_btf<CB, -kr_cospi(CB, 52), kr_cospi(CB, 12)>(t61, t66);
  const int t111 = kr_btf<CB, -kr_cospi(CB, 12), -kr_cospi(CB, 52)>(t62, t65);
  const int t112 = kr_btf<CB, -kr_cospi(CB, 52), kr_cospi(CB, 12)>(t62, t65);
  const int t113 = kr_btf<CB, kr_cospi(CB, 12), kr_cospi(CB, 52)>(t61, t66);
  const int t114 = kr_btf<CB, -kr_cospi(CB, 20), kr_cospi(CB, 44)>(t58, t69);
  const int t115 = kr_btf<CB, kr_cospi(CB, 44), kr_cospi(CB, 20)>(t57, t70);
  const int t116 = kr_btf<CB, -kr_cospi(CB, 36), kr_cospi(CB, 28)>(t54, t73);
  const int t117 = kr_btf<CB, kr_cospi(CB, 28), kr_cospi(CB, 36)>(t53, t74);
  const int t118 = kr_btf<CB, -kr_cospi(CB, 4), kr_cospi(CB, 60)>(t50, t77);
  const int t119 = kr_btf<CB, kr_cospi(CB, 60), kr_cospi(CB, 4)>(t49, t78);
  // stage 5
  const int t120 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(x8, x56);
  const int t121 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(x40, x24);
  const int t122 = kr_btf<CB, kr_cospi(CB, 40), kr_cospi(CB, 24)>(x40, x24);
  const int t123 = kr_btf<CB, kr_cospi(CB, 8), kr_cospi(CB, 56)>(x8, x56);
  const int t124 = kr_clamp<CLAMP>(add32(t80, t81), lo, hi);
  const int t125 = kr_clamp<CLAMP>(sub32(t80, t81), lo, hi);
  const int t126 = kr_clamp<CLAMP>(sub32(t83, t82), lo, hi);
  const int t127 = kr_clamp<CLAMP>(add32(t82, t83), lo, hi);
  const int t128 = kr_clamp<CLAMP>(add32(t84, t85), lo, hi);
  const int t129 = kr_clamp<CLAMP>(sub32(t84, t85), lo, hi);
  const int t130 = kr_clamp<CLAMP>(sub32(t87, t86), lo, hi);
  const int t131 = kr_clamp<CLAMP>(add32(t86, t87), lo, hi);
  const int t132 = kr_btf<CB, -kr_cospi(CB, 8), kr_cospi(CB, 56)>(t89, t102);
  const int t133 = kr_btf<CB, -kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t90, t101);
  const int t134 = kr_btf<CB, -kr_cospi(CB, 40), kr_cospi(CB, 24)>(t93, t98);
  const int t135 = kr_btf<CB, -kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t94, t97);
  const int t136 = kr_btf<CB, -kr_cospi(CB, 40), kr_cospi(CB, 24)>(t94, t97);
  const int t137 = kr_btf<CB, kr_cospi(CB, 24), kr_cospi(CB, 40)>(t93, t98);
  const int t138 = kr_btf<CB, -kr_cospi(CB, 8), kr_cospi(CB, 56)>(t90, t101);
  const int t139 = kr_btf<CB, kr_cospi(CB, 56), kr_cospi(CB, 8)>(t89, t102);
  const int t140 = kr_clamp<CLAMP>(add32(t48, t51), lo, hi);
  const int t141 = kr_clamp<CLAMP>(add32(t104, t105), lo, hi);
  const int t142 = kr_clamp<CLAMP>(sub32(t104, t105), lo, hi);
  const int t143 = kr_clamp<CLAMP>(sub32(t48, t51), lo, hi);
  const int t144 = kr_clamp<CLAMP>(sub32(t55, t52), lo, hi);
  const int t145 = kr_clamp<CLAMP>(sub32(t107, t106), lo, hi);
  const int t146 = kr_clamp<CLAMP>(add32(t106, t107), lo, hi);
  const int t147 = kr_clamp<CLAMP>(add32(t52, t55), lo, hi);
  const int t148 = kr_clamp<CLAMP>(add32(t56, t59), lo, hi);
  const int t149 = kr_clamp<CLAMP>(add32(t108, t109), lo, hi);
  const int t150 = kr_clamp<CLAMP>(sub32(t108, t109), lo, hi);
  const int t151 = kr_clamp<CLAMP>(sub32(t56, t59), lo, hi);
  const int t152 = kr_clamp<CLAMP>(sub32(t63, t60), lo, hi);
  const int t153 = kr_clamp<CLAMP>(sub32(t111, t110), lo, hi);
  const int t154 = kr_clamp<CLAMP>(add32(t110, t111), lo, hi);
  const int t155 = kr_clamp<CLAMP>(add32(t60, t63), lo, hi);
  const int t156 = kr_clamp<CLAMP>(add32(t64, t67), lo, hi);
  const int t157 = kr_clamp<CLAMP>(add32(t112, t113), lo, hi);
  const int t158 = kr_clamp<CLAMP>(sub32(t112, t113), lo, hi);
  const int t159 = kr_clamp<CLAMP>(sub32(t64, t67), lo, hi);
  const int t160 = kr_clamp<CLAMP>(sub32(t71, t68), lo, hi);
  const int t161 = kr_clamp<CLAMP>(sub32(t115, t114), lo, hi);
  const int t162 = kr_clamp<CLAMP>(add32(t114, t115), lo, hi);
  const int t163 = kr_clamp<CLAMP>(add32(t68, t71), lo, hi);
  const int t164 = kr_clamp<CLAMP>(add32(t72, t75), lo, hi);
  const int t165 = kr_clamp<CLAMP>(add32(t116, t117), lo, hi);
  const int t166 = kr_clamp<CLAMP>(sub32(t116, t117), lo, hi);
  const int t167 = kr_clamp<CLAMP>(sub32(t72, t75), lo, hi);
  const int t168 = kr_clamp<CLAMP>(sub32(t79, t76), lo, hi);
  const int t169 = kr_clamp<CLAMP>(sub32(t119, t118), lo, hi);
  const int t170 = kr_clamp<CLAMP>(add32(t118, t119), lo, hi);
  const int t171 = kr_clamp<CLAMP>(add32(t76, t79), lo, hi);
  // stage 6
  const int t172 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(x0, x32);
  const int t173 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(x0, x32);
  const int t174 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(x16, x48);
  const int t175 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(x16, x48);
  const int t176 = kr_clamp<CLAMP>(add32(t120, t121), lo, hi);
  const int t177 = kr_clamp<CLAMP>(sub32(t120, t121), lo, hi);
  const int t178 = kr_clamp<CLAMP>(sub32(t123, t122), lo, hi);
  const int t179 = kr_clamp<CLAMP>(add32(t122, t123), lo, hi);
  const int t180 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t125, t130);
  const int t181 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t126, t129);
  const int t182 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t126, t129);
  const int t183 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t125, t130);
  const int t184 = kr_clamp<CLAMP>(add32(t88, t91), lo, hi);
  const int t185 = kr_clamp<CLAMP>(add32(t132, t133), lo, hi);
  const int t186 = kr_clamp<CLAMP>(sub32(t132, t133), lo, hi);
  const int t187 = kr_clamp<CLAMP>(sub32(t88, t91), lo, hi);
  const int t188 = kr_clamp<CLAMP>(sub32(t95, t92), lo, hi);
  const int t189 = kr_clamp<CLAMP>(sub32(t135, t134), lo, hi);
  const int t190 = kr_clamp<CLAMP>(add32(t134, t135), lo, hi);
  const int t191 = kr_clamp<CLAMP>(add32(t92, t95), lo, hi);
  const int t192 = kr_clamp<CLAMP>(add32(t96, t99), lo, hi);
  const int t193 = kr_clamp<CLAMP>(add32(t136, t137), lo, hi);
  const int t194 = kr_clamp<CLAMP>(sub32(t136, t137), lo, hi);
  const int t195 = kr_clamp<CLAMP>(sub32(t96, t99), lo, hi);
  const int t196 = kr_clamp<CLAMP>(sub32(t103, t100), lo, hi);
  const int t197 = kr_clamp<CLAMP>(sub32(t139, t138), lo, hi);
  const int t198 = kr_clamp<CLAMP>(add32(t138, t139), lo, hi);
  const int t199 = kr_clamp<CLAMP>(add32(t100, t103), lo, hi);
  const int t200 = kr_btf<CB, -kr_cospi(CB, 8), kr_cospi(CB, 56)>(t142, t169);
  const int t201 = kr_btf<CB, -kr_cospi(CB, 8), kr_cospi(CB, 56)>(t143, t168);
  const int t202 = kr_btf<CB, -kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t144, t167);
  const int t203 = kr_btf<CB, -kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t145, t166);
  const int t204 = kr_btf<CB, -kr_cospi(CB, 40), kr_cospi(CB, 24)>(t150, t161);
  const int t205 = kr_btf<CB, -kr_cospi(CB, 40), kr_cospi(CB, 24)>(t151, t160);
  const int t206 = kr_btf<CB, -kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t152, t159);
  const int t207 = kr_btf<CB, -kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t153, t158);
  const int t208 = kr_btf<CB, -kr_cospi(CB, 40), kr_cospi(CB, 24)>(t153, t158);
  const int t209 = kr_btf<CB, -kr_cospi(CB, 40), kr_cospi(CB, 24)>(t152, t159);
  const int t210 = kr_btf<CB, kr_cospi(CB, 24), kr_cospi(CB, 40)>(t151, t160);
  const int t211 = kr_btf<CB, kr_cospi(CB, 24), kr_cospi(CB, 40)>(t150, t161);
  const int t212 = kr_btf<CB, -kr_cospi(CB, 8), kr_cospi(CB, 56)>(t145, t166);
  const int t213 = kr_btf<CB, -kr_cospi(CB, 8), kr_cospi(CB, 56)>(t144, t167);
  const int t214 = kr_btf<CB, kr_cospi(CB, 56), kr_cospi(CB, 8)>(t143, t168);
  const int t215 = kr_btf<CB, kr_cospi(CB, 56), kr_cospi(CB, 8)>(t142, t169);
  // stage 7
  const int t216 = kr_clamp<CLAMP>(add32(t172, t175), lo, hi);
  const int t217 = kr_clamp<CLAMP>(add32(t173, t174), lo, hi);
  const int t218 = kr_clamp<CLAMP>(sub32(t173, t174), lo, hi);
  const int t219 = kr_clamp<CLAMP>(sub32(t172, t175), lo, hi);
  const int t220 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t177, t178);
  const int t221 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t177, t178);
  const int t222 = kr_clamp<CLAMP>(add32(t124, t127), lo, hi);
  const int t223 = kr_clamp<CLAMP>(add32(t180, t181), lo, hi);
  const int t224 = kr_clamp<CLAMP>(sub32(t180, t181), lo, hi);
  const int t225 = kr_clamp<CLAMP>(sub32(t124, t127), lo, hi);
  const int t226 = kr_clamp<CLAMP>(sub32(t131, t128), lo, hi);
  const int t227 = kr_clamp<CLAMP>(sub32(t183, t182), lo, hi);
  const int t228 = kr_clamp<CLAMP>(add32(t182, t183), lo, hi);
  const int t229 = kr_clamp<CLAMP>(add32(t128, t131), lo, hi);
  const int t230 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t186, t197);
  const int t231 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t187, t196);
  const int t232 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t188, t195);
  const int t233 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t189, t194);
  const int t234 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t189, t194);
  const int t235 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t188, t195);
  const int t236 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t187, t196);
  const int t237 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t186, t197);
  const int t238 = kr_clamp<CLAMP>(add32(t140, t147), lo, hi);
  const int t239 = kr_clamp<CLAMP>(add32(t141, t146), lo, hi);
  const int t240 = kr_clamp<CLAMP>(add32(t200, t203), lo, hi);
  const int t241 = kr_clamp<CLAMP>(add32(t201, t202), lo, hi);
  const int t242 = kr_clamp<CLAMP>(sub32(t201, t202), lo, hi);
  const int t243 = kr_clamp<CLAMP>(sub32(t200, t203), lo, hi);
  const int t244 = kr_clamp<CLAMP>(sub32(t141, t146), lo, hi);
  const int t245 = kr_clamp<CLAMP>(sub32(t140, t147), lo, hi);
  const int t246 = kr_clamp<CLAMP>(sub32(t155, t148), lo, hi);
  const int t247 = kr_clamp<CLAMP>(sub32(t154, t149), lo, hi);
  const int t248 = kr_clamp<CLAMP>(sub32(t207, t204), lo, hi);
  const int t249 = kr_clamp<CLAMP>(sub32(t206, t205), lo, hi);
  const int t250 = kr_clamp<CLAMP>(add32(t205, t206), lo, hi);
  const int t251 = kr_clamp<CLAMP>(add32(t204, t207), lo, hi);
  const int t252 = kr_clamp<CLAMP>(add32(t149, t154), lo, hi);
  const int t253 = kr_clamp<CLAMP>(add32(t148, t155), lo, hi);
  const int t254 = kr_clamp<CLAMP>(add32(t156, t163), lo, hi);
  const int t255 = kr_clamp<CLAMP>(add32(t157, t162), lo, hi);
  const int t256 = kr_clamp<CLAMP>(add32(t208, t211), lo, hi);
  const int t257 = kr_clamp<CLAMP>(add32(t209, t210), lo, hi);
  const int t258 = kr_clamp<CLAMP>(sub32(t209, t210), lo, hi);
  const int t259 = kr_clamp<CLAMP>(sub32(t208, t211), lo, hi);
  const int t260 = kr_clamp<CLAMP>(sub32(t157, t162), lo, hi);
  const int t261 = kr_clamp<CLAMP>(sub32(t156, t163), lo, hi);
  const int t262 = kr_clamp<CLAMP>(sub32(t171, t164), lo, hi);
  const int t263 = kr_clamp<CLAMP>(sub32(t170, t165), lo, hi);
  const int t264 = kr_clamp<CLAMP>(sub32(t215, t212), lo, hi);
  const int t265 = kr_clamp<CLAMP>(sub32(t214, t213), lo, hi);
  const int t266 = kr_clamp<CLAMP>(add32(t213, t214), lo, hi);
  const int t267 = kr_clamp<CLAMP>(add32(t212, t215), lo, hi);
  const int t268 = kr_clamp<CLAMP>(add32(t165, t170), lo, hi);
  const int t269 = kr_clamp<CLAMP>(add32(t164, t171), lo, hi);
  // stage 8
  const int t270 = kr_clamp<CLAMP>(add32(t216, t179), lo, hi);
  const int t271 = kr_clamp<CLAMP>(add32(t217, t221), lo, hi);
  const int t272 = kr_clamp<CLAMP>(add32(t218, t220), lo, hi);
  const int t273 = kr_clamp<CLAMP>(add32(t219, t176), lo, hi);
  const int t274 = kr_clamp<CLAMP>(sub32(t219, t176), lo, hi);
  const int t275 = kr_clamp<CLAMP>(sub32(t218, t220), lo, hi);
  const int t276 = kr_clamp<CLAMP>(sub32(t217, t221), lo, hi);
  const int t277 = kr_clamp<CLAMP>(sub32(t216, t179), lo, hi);
  const int t278 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t224, t227);
  const int t279 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t225, t226);
  const int t280 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t225, t226);
  const int t281 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t224, t227);
  const int t282 = kr_clamp<CLAMP>(add32(t184, t191), lo, hi);
  const int t283 = kr_clamp<CLAMP>(add32(t185, t190), lo, hi);
  const int t284 = kr_clamp<CLAMP>(add32(t230, t233), lo, hi);
  const int t285 = kr_clamp<CLAMP>(add32(t231, t232), lo, hi);
  const int t286 = kr_clamp<CLAMP>(sub32(t231, t232), lo, hi);
  const int t287 = kr_clamp<CLAMP>(sub32(t230, t233), lo, hi);
  const int t288 = kr_clamp<CLAMP>(sub32(t185, t190), lo, hi);
  const int t289 = kr_clamp<CLAMP>(sub32(t184, t191), lo, hi);
  const int t290 = kr_clamp<CLAMP>(sub32(t199, t192), lo, hi);
  const int t291 = kr_clamp<CLAMP>(sub32(t198, t193), lo, hi);
  const int t292 = kr_clamp<CLAMP>(sub32(t237, t234), lo, hi);
  const int t293 = kr_clamp<CLAMP>(sub32(t236, t235), lo, hi);
  const int t294 = kr_clamp<CLAMP>(add32(t235, t236), lo, hi);
  const int t295 = kr_clamp<CLAMP>(add32(t234, t237), lo, hi);
  const int t296 = kr_clamp<CLAMP>(add32(t193, t198), lo, hi);
  const int t297 = kr_clamp<CLAMP>(add32(t192, t199), lo, hi);
  const int t298 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t242, t265);
  const int t299 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t243, t264);
  const int t300 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t244, t263);
  const int t301 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t245, t262);
  const int t302 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t246, t261);
  const int t303 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t247, t260);
  const int t304 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t248, t259);
  const int t305 = kr_btf<CB, -kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t249, t258);
  const int t306 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t249, t258);
  const int t307 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t248, t259);
  const int t308 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t247, t260);
  const int t309 = kr_btf<CB, -kr_cospi(CB, 16), kr_cospi(CB, 48)>(t246, t261);
  const int t310 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t245, t262);
  const int t311 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t244, t263);
  const int t312 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t243, t264);
  const int t313 = kr_btf<CB, kr_cospi(CB, 48), kr_cospi(CB, 16)>(t242, t265);
  // stage 9
  const int t314 = kr_clamp<CLAMP>(add32(t270, t229), lo, hi);
  const int t315 = kr_clamp<CLAMP>(add32(t271, t228), lo, hi);
  const int t316 = kr_clamp<CLAMP>(add32(t272, t281), lo, hi);
  const int t317 = kr_clamp<CLAMP>(add32(t273, t280), lo, hi);
  const int t318 = kr_clamp<CLAMP>(add32(t274, t279), lo, hi);
  const int t319 = kr_clamp<CLAMP>(add32(t275, t278), lo, hi);
  const int t320 = kr_clamp<CLAMP>(add32(t276, t223), lo, hi);
  const int t321 = kr_clamp<CLAMP>(add32(t277, t222), lo, hi);
  const int t322 = kr_clamp<CLAMP>(sub32(t277, t222), lo, hi);
  const int t323 = kr_clamp<CLAMP>(sub32(t276, t223), lo, hi);
  const int t324 = kr_clamp<CLAMP>(sub32(t275, t278), lo, hi);
  const int t325 = kr_clamp<CLAMP>(sub32(t274, t279), lo, hi);
  const int t326 = kr_clamp<CLAMP>(sub32(t273, t280), lo, hi);
  const int t327 = kr_clamp<CLAMP>(sub32(t272, t281), lo, hi);
  const int t328 = kr_clamp<CLAMP>(sub32(t271, t228), lo, hi);
  const int t329 = kr_clamp<CLAMP>(sub32(t270, t229), lo, hi);
  const int t330 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t286, t293);
  const int t331 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t287, t292);
  const int t332 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t288, t291);
  const int t333 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t289, t290);
  const int t334 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t289, t290);
  const int t335 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t288, t291);
  const int t336 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t287, t292);
  const int t337 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t286, t293);
  const int t338 = kr_clamp<CLAMP>(add32(t238, t253), lo, hi);
  const int t339 = kr_clamp<CLAMP>(add32(t239, t252), lo, hi);
  const int t340 = kr_clamp<CLAMP>(add32(t240, t251), lo, hi);
  const int t341 = kr_clamp<CLAMP>(add32(t241, t250), lo, hi);
  const int t342 = kr_clamp<CLAMP>(add32(t298, t305), lo, hi);
  const int t343 = kr_clamp<CLAMP>(add32(t299, t304), lo, hi);
  const int t344 = kr_clamp<CLAMP>(add32(t300, t303), lo, hi);
  const int t345 = kr_clamp<CLAMP>(add32(t301, t302), lo, hi);
  const int t346 = kr_clamp<CLAMP>(sub32(t301, t302), lo, hi);
  const int t347 = kr_clamp<CLAMP>(sub32(t300, t303), lo, hi);
  const int t348 = kr_clamp<CLAMP>(sub32(t299, t304), lo, hi);
  const int t349 = kr_clamp<CLAMP>(sub32(t298, t305), lo, hi);
  const int t350 = kr_clamp<CLAMP>(sub32(t241, t250), lo, hi);
  const int t351 = kr_clamp<CLAMP>(sub32(t240, t251), lo, hi);
  const int t352 = kr_clamp<CLAMP>(sub32(t239, t252), lo, hi);
  const int t353 = kr_clamp<CLAMP>(sub32(t238, t253), lo, hi);
  const int t354 = kr_clamp<CLAMP>(sub32(t269, t254), lo, hi);
  const int t355 = kr_clamp<CLAMP>(sub32(t268, t255), lo, hi);
  const int t356 = kr_clamp<CLAMP>(sub32(t267, t256), lo, hi);
  const int t357 = kr_clamp<CLAMP>(sub32(t266, t257), lo, hi);
  const int t358 = kr_clamp<CLAMP>(sub32(t313, t306), lo, hi);
  const int t359 = kr_clamp<CLAMP>(sub32(t312, t307), lo, hi);
  const int t360 = kr_clamp<CLAMP>(sub32(t311, t308), lo, hi);
  const int t361 = kr_clamp<CLAMP>(sub32(t310, t309), lo, hi);
  const int t362 = kr_clamp<CLAMP>(add32(t309, t310), lo, hi);
  const int t363 = kr_clamp<CLAMP>(add32(t308, t311), lo, hi);
  const int t364 = kr_clamp<CLAMP>(add32(t307, t312), lo, hi);
  const int t365 = kr_clamp<CLAMP>(add32(t306, t313), lo, hi);
  const int t366 = kr_clamp<CLAMP>(add32(t257, t266), lo, hi);
  const int t367 = kr_clamp<CLAMP>(add32(t256, t267), lo, hi);
  const int t368 = kr_clamp<CLAMP>(add32(t255, t268), lo, hi);
  const int t369 = kr_clamp<CLAMP>(add32(t254, t269), lo, hi);
  // stage 10
  const int t370 = kr_clamp<CLAMP>(add32(t314, t297), lo, hi);
  const int t371 = kr_clamp<CLAMP>(add32(t315, t296), lo, hi);
  const int t372 = kr_clamp<CLAMP>(add32(t316, t295), lo, hi);
  const int t373 = kr_clamp<CLAMP>(add32(t317, t294), lo, hi);
  const int t374 = kr_clamp<CLAMP>(add32(t318, t337), lo, hi);
  const int t375 = kr_clamp<CLAMP>(add32(t319, t336), lo, hi);
  const int t376 = kr_clamp<CLAMP>(add32(t320, t335), lo, hi);
  const int t377 = kr_clamp<CLAMP>(add32(t321, t334), lo, hi);
  const int t378 = kr_clamp<CLAMP>(add32(t322, t333), lo, hi);
  const int t379 = kr_clamp<CLAMP>(add32(t323, t332), lo, hi);
  const int t380 = kr_clamp<CLAMP>(add32(t324, t331), lo, hi);
  const int t381 = kr_clamp<CLAMP>(add32(t325, t330), lo, hi);
  const int t382 = kr_clamp<CLAMP>(add32(t326, t285), lo, hi);
  const int t383 = kr_clamp<CLAMP>(add32(t327, t284), lo, hi);
  const int t384 = kr_clamp<CLAMP>(add32(t328, t283), lo, hi);
  const int t385 = kr_clamp<CLAMP>(add32(t329, t282), lo, hi);
  const int t386 = kr_clamp<CLAMP>(sub32(t329, t282), lo, hi);
  const int t387 = kr_clamp<CLAMP>(sub32(t328, t283), lo, hi);
  const int t388 = kr_clamp<CLAMP>(sub32(t327, t284), lo, hi);
  const int t389 = kr_clamp<CLAMP>(sub32(t326, t285), lo, hi);
  const int t390 = kr_clamp<CLAMP>(sub32(t325, t330), lo, hi);
  const int t391 = kr_clamp<CLAMP>(sub32(t324, t331), lo, hi);
  const int t392 = kr_clamp<CLAMP>(sub32(t323, t332), lo, hi);
  const int t393 = kr_clamp<CLAMP>(sub32(t322, t333), lo, hi);
  const int t394 = kr_clamp<CLAMP>(sub32(t321, t334), lo, hi);
  const int t395 = kr_clamp<CLAMP>(sub32(t320, t335), lo, hi);
  const int t396 = kr_clamp<CLAMP>(sub32(t319, t336), lo, hi);
  const int t397 = kr_clamp<CLAMP>(sub32(t318, t337), lo, hi);
  const int t398 = kr_clamp<CLAMP>(sub32(t317, t294), lo, hi);
  const int t399 = kr_clamp<CLAMP>(sub32(t316, t295), lo, hi);
  const int t400 = kr_clamp<CLAMP>(sub32(t315, t296), lo, hi);
  const int t401 = kr_clamp<CLAMP>(sub32(t314, t297), lo, hi);
  const int t402 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t346, t361);
  const int t403 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t347, t360);
  const int t404 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t348, t359);
  const int t405 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t349, t358);
  const int t406 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t350, t357);
  const int t407 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t351, t356);
  const int t408 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t352, t355);
  const int t409 = kr_btf<CB, -kr_cospi(CB, 32), kr_cospi(CB, 32)>(t353, t354);
  const int t410 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t353, t354);
  const int t411 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t352, t355);
  const int t412 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t351, t356);
  const int t413 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t350, t357);
  const int t414 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t349, t358);
  const int t415 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t348, t359);
  const int t416 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t347, t360);
  const int t417 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t346, t361);
  // stage 11
  const int t418 = kr_clamp<CLAMP>(add32(t370, t369), lo, hi);
  const int t419 = kr_clamp<CLAMP>(add32(t371, t368), lo, hi);
  const int t420 = kr_clamp<CLAMP>(add32(t372, t367), lo, hi);
  const int t421 = kr_clamp<CLAMP>(add32(t373, t366), lo, hi);
  const int t422 = kr_clamp<CLAMP>(add32(t374, t365), lo, hi);
  const int t423 = kr_clamp<CLAMP>(add32(t375, t364), lo, hi);
  const int t424 = kr_clamp<CLAMP>(add32(t376, t363), lo, hi);
  const int t425 = kr_clamp<CLAMP>(add32(t377, t362), lo, hi);
  const int t426 = kr_clamp<CLAMP>(add32(t378, t417), lo, hi);
  const int t427 = kr_clamp<CLAMP>(add32(t379, t416), lo, hi);
  const int t428 = kr_clamp<CLAMP>(add32(t380, t415), lo, hi);
  const int t429 = kr_clamp<CLAMP>(add32(t381, t414), lo, hi);
  const int t430 = kr_clamp<CLAMP>(add32(t382, t413), lo, hi);
  const int t431 = kr_clamp<CLAMP>(add32(t383, t412), lo, hi);
  const int t432 = kr_clamp<CLAMP>(add32(t384, t411), lo, hi);
  const int t433 = kr_clamp<CLAMP>(add32(t385, t410), lo, hi);
  const int t434 = kr_clamp<CLAMP>(add32(t386, t409), lo, hi);
  const int t435 = kr_clamp<CLAMP>(add32(t387, t408), lo, hi);
  const int t436 = kr_clamp<CLAMP>(add32(t388, t407), lo, hi);
  const int t437 = kr_clamp<CLAMP>(add32(t389, t406), lo, hi);
  const int t438 = kr_clamp<CLAMP>(add32(t390, t405), lo, hi);
  const int t439 = kr_clamp<CLAMP>(add32(t391, t404), lo, hi);
  const int t440 = kr_clamp<CLAMP>(add32(t392, t403), lo, hi);
  const int t441 = kr_clamp<CLAMP>(add32(t393, t402), lo, hi);
  const int t442 = kr_clamp<CLAMP>(add32(t394, t345), lo, hi);
  const int t443 = kr_clamp<CLAMP>(add32(t395, t344), lo, hi);
  const int t444 = kr_clamp<CLAMP>(add32(t396, t343), lo, hi);
  const int t445 = kr_clamp<CLAMP>(add32(t397, t342), lo, hi);
  const int t446 = kr_clamp<CLAMP>(add32(t398, t341), lo, hi);
  const int t447 = kr_clamp<CLAMP>(add32(t399, t340), lo, hi);
  const int t448 = kr_clamp<CLAMP>(add32(t400, t339), lo, hi);
  const int t449 = kr_clamp<CLAMP>(add32(t401, t338), lo, hi);
  const int t450 = kr_clamp<CLAMP>(sub32(t401, t338), lo, hi);
  const int t451 = kr_clamp<CLAMP>(sub32(t400, t339), lo, hi);
  const int t452 = kr_clamp<CLAMP>(sub32(t399, t340), lo, hi);
  const int t453 = kr_clamp<CLAMP>(sub32(t398, t341), lo, hi);
  const int t454 = kr_clamp<CLAMP>(sub32(t397, t342), lo, hi);
  const int t455 = kr_clamp<CLAMP>(sub32(t396, t343), lo, hi);
  const int t456 = kr_clamp<CLAMP>(sub32(t395, t344), lo, hi);
  const int t457 = kr_clamp<CLAMP>(sub32(t394, t345), lo, hi);
  const int t458 = kr_clamp<CLAMP>(sub32(t393, t402), lo, hi);
  const int t459 = kr_clamp<CLAMP>(sub32(t392, t403), lo, hi);
  const int t460 = kr_clamp<CLAMP>(sub32(t391, t404), lo, hi);
  const int t461 = kr_clamp<CLAMP>(sub32(t390, t405), lo, hi);
  const int t462 = kr_clamp<CLAMP>(sub32(t389, t406), lo, hi);
  const int t463 = kr_clamp<CLAMP>(sub32(t388, t407), lo, hi);
  const int t464 = kr_clamp<CLAMP>(sub32(t387, t408), lo, hi);
  const int t465 = kr_clamp<CLAMP>(sub32(t386, t409), lo, hi);
  const int t466 = kr_clamp<CLAMP>(sub32(t385, t410), lo, hi);
  const int t467 = kr_clamp<CLAMP>(sub32(t384, t411), lo, hi);
  const int t468 = kr_clamp<CLAMP>(sub32(t383, t412), lo, hi);
  const int t469 = kr_clamp<CLAMP>(sub32(t382, t413), lo, hi);
  const int t470 = kr_clamp<CLAMP>(sub32(t381, t414), lo, hi);
  const int t471 = kr_clamp<CLAMP>(sub32(t380, t415), lo, hi);
  const int t472 = kr_clamp<CLAMP>(sub32(t379, t416), lo, hi);
  const int t473 = kr_clamp<CLAMP>(sub32(t378, t417), lo, hi);
  const int t474 = kr_clamp<CLAMP>(sub32(t377, t362), lo, hi);
  const int t475 = kr_clamp<CLAMP>(sub32(t376, t363), lo, hi);
  const int t476 = kr_clamp<CLAMP>(sub32(t375, t364), lo, hi);
  const int t477 = kr_clamp<CLAMP>(sub32(t374, t365), lo, hi);
  const int t478 = kr_clamp<CLAMP>(sub32(t373, t366), lo, hi);
  const int t479 = kr_clamp<CLAMP>(sub32(t372, t367), lo, hi);
  const int t480 = kr_clamp<CLAMP>(sub32(t371, t368), lo, hi);
  const int t481 = kr_clamp<CLAMP>(sub32(t370, t369), lo, hi);
  x[0] = t418;
  x[1] = t419;
  x[2] = t420;
  x[3] = t421;
  x[4] = t422;
  x[5] = t423;
  x[6] = t424;
  x[7] = t425;
  x[8] = t426;
  x[9] = t427;
  x[10] = t428;
  x[11] = t429;
  x[12] = t430;
  x[13] = t431;
  x[14] = t432;
  x[15] = t433;
  x[16] = t434;
  x[17] = t435;
  x[18] = t436;
  x[19] = t437;
  x[20] = t438;
  x[21] = t439;
  x[22] = t440;
  x[23] = t441;
  x[24] = t442;
  x[25] = t443;
  x[26] = t444;
  x[27] = t445;
  x[28] = t446;
  x[29] = t447;
  x[30] = t448;
  x[31] = t449;
  x[32] = t450;
  x[33] = t451;
  x[34] = t452;
  x[35] = t453;
  x[36] = t454;
  x[37] = t455;
  x[38] = t456;
  x[39] = t457;
  x[40] = t458;
  x[41] = t459;
  x[42] = t460;
  x[43] = t461;
  x[44] = t462;
  x[45] = t463;
  x[46] = t464;
  x[47] = t465;
  x[48] = t466;
  x[49] = t467;
  x[50] = t468;
  x[51] = t469;
  x[52] = t470;
  x[53] = t471;
  x[54] = t472;
  x[55] = t473;
  x[56] = t474;
  x[57] = t475;
  x[58] = t476;
  x[59] = t477;
  x[60] = t478;
  x[61] = t479;
  x[62] = t480;
  x[63] = t481;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_iadst8(int (&x)[8], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  const int x4 = x[4];
  const int x5 = x[5];
  const int x6 = x[6];
  const int x7 = x[7];
  // stage 1
  // stage 2
  const int t0 = kr_btf<CB, kr_cospi(CB, 4), kr_cospi(CB, 60)>(x7, x0);
  const int t1 = kr_btf<CB, kr_cospi(CB, 60), -kr_cospi(CB, 4)>(x7, x0);
  const int t2 = kr_btf<CB, kr_cospi(CB, 20), kr_cospi(CB, 44)>(x5, x2);
  const int t3 = kr_btf<CB, kr_cospi(CB, 44), -kr_cospi(CB, 20)>(x5, x2);
  const int t4 = kr_btf<CB, kr_cospi(CB, 36), kr_cospi(CB, 28)>(x3, x4);
  const int t5 = kr_btf<CB, kr_cospi(CB, 28), -kr_cospi(CB, 36)>(x3, x4);
  const int t6 = kr_btf<CB, kr_cospi(CB, 52), kr_cospi(CB, 12)>(x1, x6);
  const int t7 = kr_btf<CB, kr_cospi(CB, 12), -kr_cospi(CB, 52)>(x1, x6);
  // stage 3
  const int t8 = kr_clamp<CLAMP>(add32(t0, t4), lo, hi);
  const int t9 = kr_clamp<CLAMP>(add32(t1, t5), lo, hi);
  const int t10 = kr_clamp<CLAMP>(add32(t2, t6), lo, hi);
  const int t11 = kr_clamp<CLAMP>(add32(t3, t7), lo, hi);
  const int t12 = kr_clamp<CLAMP>(sub32(t0, t4), lo, hi);
  const int t13 = kr_clamp<CLAMP>(sub32(t1, t5), lo, hi);
  const int t14 = kr_clamp<CLAMP>(sub32(t2, t6), lo, hi);
  const int t15 = kr_clamp<CLAMP>(sub32(t3, t7), lo, hi);
  // stage 4
  const int t16 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t12, t13);
  const int t17 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t12, t13);
  const int t18 = kr_btf<CB, -kr_cospi(CB, 48), kr_cospi(CB, 16)>(t14, t15);
  const int t19 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t14, t15);
  // stage 5
  const int t20 = kr_clamp<CLAMP>(add32(t8, t10), lo, hi);
  const int t21 = kr_clamp<CLAMP>(add32(t9, t11), lo, hi);
  const int t22 = kr_clamp<CLAMP>(sub32(t8, t10), lo, hi);
  const int t23 = kr_clamp<CLAMP>(sub32(t9, t11), lo, hi);
  const int t24 = kr_clamp<CLAMP>(add32(t16, t18), lo, hi);
  const int t25 = kr_clamp<CLAMP>(add32(t17, t19), lo, hi);
  const int t26 = kr_clamp<CLAMP>(sub32(t16, t18), lo, hi);
  const int t27 = kr_clamp<CLAMP>(sub32(t17, t19), lo, hi);
  // stage 6
  const int t28 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t22, t23);
  const int t29 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(t22, t23);
  const int t30 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t26, t27);
  const int t31 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(t26, t27);
  // stage 7
  const int t32 = sub32(0, t24);
  const int t33 = sub32(0, t28);
  const int t34 = sub32(0, t31);
  const int t35 = sub32(0, t21);
  x[0] = t20;
  x[1] = t32;
  x[2] = t30;
  x[3] = t33;
  x[4] = t29;
  x[5] = t34;
  x[6] = t25;
  x[7] = t35;
}

template <int CB, bool CLAMP>
__device__ __forceinline__ void kr_iadst16(int (&x)[16], int lo, int hi) {
  const int x0 = x[0];
  const int x1 = x[1];
  const int x2 = x[2];
  const int x3 = x[3];
  const int x4 = x[4];
  const int x5 = x[5];
  const int x6 = x[6];
  const int x7 = x[7];
  const int x8 = x[8];
  const int x9 = x[9];
  const int x10 = x[10];
  const int x11 = x[11];
  const int x12 = x[12];
  const int x13 = x[13];
  const int x14 = x[14];
  const int x15 = x[15];
  // stage 1
  // stage 2
  const int t0 = kr_btf<CB, kr_cospi(CB, 2), kr_cospi(CB, 62)>(x15, x0);
  const int t1 = kr_btf<CB, kr_cospi(CB, 62), -kr_cospi(CB, 2)>(x15, x0);
  const int t2 = kr_btf<CB, kr_cospi(CB, 10), kr_cospi(CB, 54)>(x13, x2);
  const int t3 = kr_btf<CB, kr_cospi(CB, 54), -kr_cospi(CB, 10)>(x13, x2);
  const int t4 = kr_btf<CB, kr_cospi(CB, 18), kr_cospi(CB, 46)>(x11, x4);
  const int t5 = kr_btf<CB, kr_cospi(CB, 46), -kr_cospi(CB, 18)>(x11, x4);
  const int t6 = kr_btf<CB, kr_cospi(CB, 26), kr_cospi(CB, 38)>(x9, x6);
  const int t7 = kr_btf<CB, kr_cospi(CB, 38), -kr_cospi(CB, 26)>(x9, x6);
  const int t8 = kr_btf<CB, kr_cospi(CB, 34), kr_cospi(CB, 30)>(x7, x8);
  const int t9 = kr_btf<CB, kr_cospi(CB, 30), -kr_cospi(CB, 34)>(x7, x8);
  const int t10 = kr_btf<CB, kr_cospi(CB, 42), kr_cospi(CB, 22)>(x5, x10);
  const int t11 = kr_btf<CB, kr_cospi(CB, 22), -kr_cospi(CB, 42)>(x5, x10);
  const int t12 = kr_btf<CB, kr_cospi(CB, 50), kr_cospi(CB, 14)>(x3, x12);
  const int t13 = kr_btf<CB, kr_cospi(CB, 14), -kr_cospi(CB, 50)>(x3, x12);
  const int t14 = kr_btf<CB, kr_cospi(CB, 58), kr_cospi(CB, 6)>(x1, x14);
  const int t15 = kr_btf<CB, kr_cospi(CB, 6), -kr_cospi(CB, 58)>(x1, x14);
  // stage 3
  const int t16 = kr_clamp<CLAMP>(add32(t0, t8), lo, hi);
  const int t17 = kr_clamp<CLAMP>(add32(t1, t9), lo, hi);
  const int t18 = kr_clamp<CLAMP>(add32(t2, t10), lo, hi);
  const int t19 = kr_clamp<CLAMP>(add32(t3, t11), lo, hi);
  const int t20 = kr_clamp<CLAMP>(add32(t4, t12), lo, hi);
  const int t21 = kr_clamp<CLAMP>(add32(t5, t13), lo, hi);
  const int t22 = kr_clamp<CLAMP>(add32(t6, t14), lo, hi);
  const int t23 = kr_clamp<CLAMP>(add32(t7, t15), lo, hi);
  const int t24 = kr_clamp<CLAMP>(sub32(t0, t8), lo, hi);
  const int t25 = kr_clamp<CLAMP>(sub32(t1, t9), lo, hi);
  const int t26 = kr_clamp<CLAMP>(sub32(t2, t10), lo, hi);
  const int t27 = kr_clamp<CLAMP>(sub32(t3, t11), lo, hi);
  const int t28 = kr_clamp<CLAMP>(sub32(t4, t12), lo, hi);
  const int t29 = kr_clamp<CLAMP>(sub32(t5, t13), lo, hi);
  const int t30 = kr_clamp<CLAMP>(sub32(t6, t14), lo, hi);
  const int t31 = kr_clamp<CLAMP>(sub32(t7, t15), lo, hi);
  // stage 4
  const int t32 = kr_btf<CB, kr_cospi(CB, 8), kr_cospi(CB, 56)>(t24, t25);
  const int t33 = kr_btf<CB, kr_cospi(CB, 56), -kr_cospi(CB, 8)>(t24, t25);
  const int t34 = kr_btf<CB, kr_cospi(CB, 40), kr_cospi(CB, 24)>(t26, t27);
  const int t35 = kr_btf<CB, kr_cospi(CB, 24), -kr_cospi(CB, 40)>(t26, t27);
  const int t36 = kr_btf<CB, -kr_cospi(CB, 56), kr_cospi(CB, 8)>(t28, t29);
  const int t37 = kr_btf<CB, kr_cospi(CB, 8), kr_cospi(CB, 56)>(t28, t29);
  const int t38 = kr_btf<CB, -kr_cospi(CB, 24), kr_cospi(CB, 40)>(t30, t31);
  const int t39 = kr_btf<CB, kr_cospi(CB, 40), kr_cospi(CB, 24)>(t30, t31);
  // stage 5
  const int t40 = kr_clamp<CLAMP>(add32(t16, t20), lo, hi);
  const int t41 = kr_clamp<CLAMP>(add32(t17, t21), lo, hi);
  const int t42 = kr_clamp<CLAMP>(add32(t18, t22), lo, hi);
  const int t43 = kr_clamp<CLAMP>(add32(t19, t23), lo, hi);
  const int t44 = kr_clamp<CLAMP>(sub32(t16, t20), lo, hi);
  const int t45 = kr_clamp<CLAMP>(sub32(t17, t21), lo, hi);
  const int t46 = kr_clamp<CLAMP>(sub32(t18, t22), lo, hi);
  const int t47 = kr_clamp<CLAMP>(sub32(t19, t23), lo, hi);
  const int t48 = kr_clamp<CLAMP>(add32(t32, t36), lo, hi);
  const int t49 = kr_clamp<CLAMP>(add32(t33, t37), lo, hi);
  const int t50 = kr_clamp<CLAMP>(add32(t34, t38), lo, hi);
  const int t51 = kr_clamp<CLAMP>(add32(t35, t39), lo, hi);
  const int t52 = kr_clamp<CLAMP>(sub32(t32, t36), lo, hi);
  const int t53 = kr_clamp<CLAMP>(sub32(t33, t37), lo, hi);
  const int t54 = kr_clamp<CLAMP>(sub32(t34, t38), lo, hi);
  const int t55 = kr_clamp<CLAMP>(sub32(t35, t39), lo, hi);
  // stage 6
  const int t56 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t44, t45);
  const int t57 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t44, t45);
  const int t58 = kr_btf<CB, -kr_cospi(CB, 48), kr_cospi(CB, 16)>(t46, t47);
  const int t59 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t46, t47);
  const int t60 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t52, t53);
  const int t61 = kr_btf<CB, kr_cospi(CB, 48), -kr_cospi(CB, 16)>(t52, t53);
  const int t62 = kr_btf<CB, -kr_cospi(CB, 48), kr_cospi(CB, 16)>(t54, t55);
  const int t63 = kr_btf<CB, kr_cospi(CB, 16), kr_cospi(CB, 48)>(t54, t55);
  // stage 7
  const int t64 = kr_clamp<CLAMP>(add32(t40, t42), lo, hi);
  const int t65 = kr_clamp<CLAMP>(add32(t41, t43), lo, hi);
  const int t66 = kr_clamp<CLAMP>(sub32(t40, t42), lo, hi);
  const int t67 = kr_clamp<CLAMP>(sub32(t41, t43), lo, hi);
  const int t68 = kr_clamp<CLAMP>(add32(t56, t58), lo, hi);
  const int t69 = kr_clamp<CLAMP>(add32(t57, t59), lo, hi);
  const int t70 = kr_clamp<CLAMP>(sub32(t56, t58), lo, hi);
  const int t71 = kr_clamp<CLAMP>(sub32(t57, t59), lo, hi);
  const int t72 = kr_clamp<CLAMP>(add32(t48, t50), lo, hi);
  const int t73 = kr_clamp<CLAMP>(add32(t49, t51), lo, hi);
  const int t74 = kr_clamp<CLAMP>(sub32(t48, t50), lo, hi);
  const int t75 = kr_clamp<CLAMP>(sub32(t49, t51), lo, hi);
  const int t76 = kr_clamp<CLAMP>(add32(t60, t62), lo, hi);
  const int t77 = kr_clamp<CLAMP>(add32(t61, t63), lo, hi);
  const int t78 = kr_clamp<CLAMP>(sub32(t60, t62), lo, hi);
  const int t79 = kr_clamp<CLAMP>(sub32(t61, t63), lo, hi);
  // stage 8
  const int t80 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t66, t67);
  const int t81 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(t66, t67);
  const int t82 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t70, t71);
  const int t83 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(t70, t71);
  const int t84 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t74, t75);
  const int t85 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(t74, t75);
  const int t86 = kr_btf<CB, kr_cospi(CB, 32), kr_cospi(CB, 32)>(t78, t79);
  const int t87 = kr_btf<CB, kr_cospi(CB, 32), -kr_cospi(CB, 32)>(t78, t79);
  // stage 9
  const int t88 = sub32(0, t72);
  const int t89 = sub32(0, t68);
  const int t90 = sub32(0, t86);
  const int t91 = sub32(0, t80);
  const int t92 = sub32(0, t85);
  const int t93 = sub32(0, t83);
  const int t94 = sub32(0, t77);
  const int t95 = sub32(0, t65);
  x[0] = t64;
  x[1] = t88;
  x[2] = t76;
  x[3] = t89;
  x[4] = t82;
  x[5] = t90;
  x[6] = t84;
  x[7] = t91;
  x[8] = t81;
  x[9] = t92;
  x[10] = t87;
  x[11] = t93;
  x[12] = t69;
  x[13] = t94;
  x[14] = t73;
  x[15] = t95;
}
