// Native host-side golden NTT and field helpers for sventt_tpu.
//
// C++ analogue of the reference's exact oracle (reference
// tests/ntt-reference.hpp: naive radix-2 NTT over unsigned __int128,
// canonical [0, N), DIF forward emitting bit-reversed order, DIT inverse
// pre-scaled by m^-1).  The Python golden model (field/golden.py) is the
// semantic source of truth; this library reproduces it at native speed so
// large-n transforms (2^17+) can be verified against an independent oracle
// in seconds.  Loaded via ctypes (native/__init__.py).
//
// Build: c++ -O3 -fopenmp -shared -fPIC host_golden.cc series.cc \
//          -o libsventt_host.so   (OpenMP is optional: without it the
//          pragmas are ignored and the loops run on one thread)

#include <cstdint>
#include <new>

using u64 = std::uint64_t;
using u128 = unsigned __int128;

extern "C" {

static u64 mulmod(u64 a, u64 b, u64 N) { return (u128)a * b % N; }

static u64 powmod(u64 a, u64 e, u64 N) {
  u64 r = 1 % N;
  a %= N;
  while (e) {
    if (e & 1) r = mulmod(r, a, N);
    a = mulmod(a, a, N);
    e >>= 1;
  }
  return r;
}

u64 sventt_powmod(u64 a, u64 e, u64 N) { return powmod(a, e, N); }

u64 sventt_invmod(u64 a, u64 N) { return powmod(a, N - 2, N); }

// Montgomery product a*b*2^-64 mod N for any odd N < 2^64 and a, b < N
// (subtractive REDC: q*N agrees with a*b in the low word, so the high words
// differ by less than N and one conditional add lands in [0, N)).
static inline u64 mont_mul(u64 a, u64 b, u64 N, u64 ninv) {
  u128 t = (u128)a * b;
  u64 q = (u64)t * ninv;
  u64 thi = (u64)(t >> 64);
  u64 qn = (u64)(((u128)q * N) >> 64);
  return thi >= qn ? thi - qn : thi - qn + N;
}

// a + b and a - b mod N without 128-bit arithmetic: a carry out of the
// 64-bit sum means the true sum is >= 2^64 > N.
static inline u64 add_n(u64 a, u64 b, u64 N) {
  u64 s = a + b;
  return (s < a || s >= N) ? s - N : s;
}
static inline u64 sub_n(u64 a, u64 b, u64 N) {
  return a >= b ? a - b : a - b + N;
}

static u64 inv_2_64(u64 N) {
  u64 inv = N;  // correct mod 2^3 for odd N
  for (int i = 0; i < 5; ++i) inv *= 2 - N * inv;
  return inv;
}

// x * 2^64 mod N: the Montgomery form of x.
static u64 to_mont(u64 x, u64 N) { return (u64)((((u128)x) << 64) % N); }

// tab[j] = root^j * 2^64 mod N for j < len (Montgomery form), filled in
// parallel chunks that each start from a direct power.
static void power_table(u64 *tab, u64 len, u64 root, u64 N, u64 ninv) {
  const u64 chunk = 1 << 14;
  const u64 root_m = to_mont(root, N);
#pragma omp parallel for schedule(static) if (len > chunk)
  for (long long c = 0; c < (long long)((len + chunk - 1) / chunk); ++c) {
    u64 j0 = (u64)c * chunk;
    u64 w = to_mont(powmod(root, j0, N), N);
    u64 end = j0 + chunk < len ? j0 + chunk : len;
    for (u64 j = j0; j < end; ++j) {
      tab[j] = w;
      w = mont_mul(w, root_m, N, ninv);
    }
  }
}

// Forward DIF NTT in place: data[0..m), canonical residues in, canonical
// out, bit-reversed order (tests/ntt-reference.hpp:43-61 semantics).
// omega_m: primitive m-th root g^((N-1)/m).  Returns 0 on success, 2 if
// the twiddle table cannot be allocated.
//
// Stage-major radix-2 with one table of omega_m^j (j < m/2); the stage of
// half-length l reads it at stride m/(2l), since omega_2l = omega_m^(m/2l).
// Every stage's m/2 butterflies are independent and split across threads.
int sventt_golden_forward(u64 *data, u64 m, u64 N, u64 omega_m) {
  if (m == 0 || (m & (m - 1))) return 1;
  if (m == 1) return 0;
  const u64 ninv = inv_2_64(N);
  u64 *tab = new (std::nothrow) u64[m / 2];
  if (!tab) return 2;
  power_table(tab, m / 2, omega_m, N, ninv);
  for (u64 l = m >> 1; l >= 1; l >>= 1) {
    const u64 stride = m / (2 * l);
    const unsigned sh = __builtin_ctzll(l);
#pragma omp parallel for schedule(static) if (m >= (1 << 15))
    for (long long i = 0; i < (long long)(m / 2); ++i) {
      u64 j = (u64)i & (l - 1);
      u64 k = (((u64)i >> sh) << (sh + 1)) + j;
      u64 x0 = data[k], x1 = data[k + l];
      data[k] = add_n(x0, x1, N);
      data[k + l] = mont_mul(sub_n(x0, x1, N), tab[j * stride], N, ninv);
    }
    if (l == 1) break;
  }
  delete[] tab;
  return 0;
}

// Inverse DIT NTT in place: consumes bit-reversed order, emits natural
// order scaled by m^-1 (tests/ntt-reference.hpp:63-83 semantics).  Same
// loop structure as the forward, on a table of omega_m^-j.
int sventt_golden_inverse(u64 *data, u64 m, u64 N, u64 omega_m) {
  if (m == 0 || (m & (m - 1))) return 1;
  const u64 ninv = inv_2_64(N);
  const u64 minv_m = to_mont(powmod(m % N, N - 2, N), N);
#pragma omp parallel for schedule(static) if (m >= (1 << 15))
  for (long long i = 0; i < (long long)m; ++i)
    data[i] = mont_mul(data[i], minv_m, N, ninv);
  if (m == 1) return 0;
  u64 *tab = new (std::nothrow) u64[m / 2];
  if (!tab) return 2;
  power_table(tab, m / 2, powmod(omega_m, N - 2, N), N, ninv);
  for (u64 l = 1; l < m; l <<= 1) {
    const u64 stride = m / (2 * l);
    const unsigned sh = __builtin_ctzll(l);
#pragma omp parallel for schedule(static) if (m >= (1 << 15))
    for (long long i = 0; i < (long long)(m / 2); ++i) {
      u64 j = (u64)i & (l - 1);
      u64 k = (((u64)i >> sh) << (sh + 1)) + j;
      u64 x0 = data[k];
      u64 x1 = mont_mul(data[k + l], tab[j * stride], N, ninv);
      data[k] = add_n(x0, x1, N);
      data[k + l] = sub_n(x0, x1, N);
    }
  }
  delete[] tab;
  return 0;
}

// Pointwise product c[i] = a[i] * b[i] mod N of canonical residues (the
// spectral step of an NTT convolution, for application-level checks).
int sventt_pointwise_mulmod(const u64 *a, const u64 *b, u64 *c, u64 m,
                            u64 N) {
#pragma omp parallel for schedule(static) if (m >= (1 << 15))
  for (long long i = 0; i < (long long)m; ++i) c[i] = mulmod(a[i], b[i], N);
  return 0;
}

// Cyclic convolution oracle: c = a (*) b mod N via schoolbook O(m^2)
// (fully independent of any NTT code path, for application-level checks).
int sventt_cyclic_convolve_naive(const u64 *a, const u64 *b, u64 *c, u64 m,
                                 u64 N) {
  for (u64 k = 0; k < m; ++k) {
    u128 acc = 0;
    for (u64 j = 0; j < m; ++j) {
      u64 idx = (k + m - j) % m;
      acc += (u128)(mulmod(a[j], b[idx], N));
      if ((j & 0xff) == 0xff) acc %= N;
    }
    c[k] = (u64)(acc % N);
  }
  return 0;
}

// Montgomery / Shoup companions (host table generation parity helpers).
u64 sventt_montgomery_inverse(u64 N) {
  // Newton iteration for N^-1 mod 2^64 (reference modulus.hpp:36-68 role).
  return inv_2_64(N);
}

u64 sventt_shoup_precompute(u64 w, u64 N) {
  return (u64)((((u128)w) << 64) / N);
}

}  // extern "C"
