// defuse-tpu native host library
//
// C++ implementations of the sequential host-side stages that wrap the
// device compute path: discordant mate-pair clustering (binning + exact
// mixture EM; algorithm spec: reference tools/clustermatepairs.cpp and
// tools/MatePairEM.cpp — independently written against the byte-level
// contracts the Python oracles in defuse_tpu/cluster/ pin down; the
// exact M-step's knot enumeration necessarily mirrors the reference's
// event structure since fp-identical results require an identical
// reduction order), AS 136 k-means seeding, and greedy set cover
// (tools/setcover.cpp contract, canonical lowest-id tie-break).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
// Build: ./build.sh -> libdefuse_host.so

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <zlib.h>
#ifdef HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

namespace {

// --- gzip helpers ----------------------------------------------------
// Large checkpoint artifacts (cdna.pair.sam) are written gzipped: the
// working filesystem sustains ~70MB/s, so a 300MB SAM costs ~4s of
// wall clock while level-1 deflate shrinks it ~4x for ~0.25s/thread of
// CPU.  Each writer thread emits a standalone gzip member; members
// concatenate into one valid stream (RFC 1952 §2.2), so ordered writes
// and shard-merge-by-append both stay legal.

inline bool GzipMember(const std::string& in, std::string& out,
                       int level = 1) {
#ifdef HAVE_LIBDEFLATE
  // libdeflate one-shot gzip: ~2-3x zlib's deflate rate at the same
  // level, standard gzip stream (zlib/gzip readers decompress it).
  // Inputs past 1GB (or allocator failure) fall through to the
  // streaming zlib path below.
  if (in.size() < (1u << 30)) {
    libdeflate_compressor* c = libdeflate_alloc_compressor(level);
    if (c) {
      size_t bound = libdeflate_gzip_compress_bound(c, in.size());
      out.resize(bound);
      size_t n = libdeflate_gzip_compress(c, in.data(), in.size(),
                                          &out[0], bound);
      libdeflate_free_compressor(c);
      if (n) {
        out.resize(n);
        return true;
      }
    }
  }
#endif
  z_stream zs{};
  if (deflateInit2(&zs, level, Z_DEFLATED, 15 + 16, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    return false;
  out.resize((size_t)deflateBound(&zs, (uLong)std::min<size_t>(
                 in.size(), 1u << 30)) + in.size() / 1000 + 64);
  size_t in_pos = 0, out_pos = 0;
  int rc = Z_OK;
  do {
    uInt chunk = (uInt)std::min<size_t>(in.size() - in_pos, 1u << 30);
    zs.next_in = (Bytef*)in.data() + in_pos;
    zs.avail_in = chunk;
    bool last = (in_pos + chunk == in.size());
    do {
      if (out_pos + (1 << 16) > out.size()) out.resize(out.size() * 2);
      zs.next_out = (Bytef*)&out[out_pos];
      zs.avail_out = (uInt)(out.size() - out_pos);
      rc = deflate(&zs, last ? Z_FINISH : Z_NO_FLUSH);
      out_pos = (char*)zs.next_out - out.data();
      if (rc == Z_STREAM_ERROR) break;
    } while (zs.avail_out == 0 || (last && rc != Z_STREAM_END));
    in_pos = (char*)zs.next_in - in.data();
  } while (rc != Z_STREAM_END && rc != Z_STREAM_ERROR);
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return false;
  out.resize(out_pos);
  return true;
}

inline bool EndsWithGz(const char* path) {
  size_t n = strlen(path);
  return n >= 3 && strcmp(path + n - 3, ".gz") == 0;
}

// Buffered line reader over a possibly-gzipped file (zlib gzFile reads
// plain files transparently, so callers never sniff the format).
struct GzIn {
  gzFile f = nullptr;
  char buf[1 << 16];
  size_t pos = 0, len = 0;
  bool open(const char* path) {
    f = gzopen(path, "rb");
    if (f) gzbuffer(f, 1 << 20);
    return f != nullptr;
  }
  ~GzIn() {
    if (f) gzclose(f);
  }
  bool getline(std::string& out) {
    out.clear();
    for (;;) {
      if (pos >= len) {
        int n = gzread(f, buf, sizeof buf);
        if (n <= 0) return !out.empty();
        pos = 0;
        len = (size_t)n;
      }
      char* nl = (char*)memchr(buf + pos, '\n', len - pos);
      if (nl) {
        out.append(buf + pos, nl - (buf + pos));
        pos = (size_t)(nl - buf) + 1;
        return true;
      }
      out.append(buf + pos, len - pos);
      pos = len;
    }
  }
};

// EM phase accumulators (DT_TIMING diagnostics; ns, across threads)
static std::atomic<long> g_em_init_ns{0}, g_em_mstep_ns{0},
    g_em_estep_ns{0};
static inline long NowNs() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

constexpr double kLambda = 0.1;
constexpr double kTolerance = 0.001;
constexpr int kKMax = 10;
constexpr int kKMeansIter = 1000;
constexpr double kHuge = 1.0e30;

// ---------------------------------------------------------------------
// Bit-exact vectorized exp twin (AVX-512, 8 lanes)
//
// The EM E-step is exp-bound (~25M libm exp calls on the 92.8k-pair
// bench dataset).  This is an 8-lane re-expression of the table-driven
// exp algorithm published in ARM optimized-routines / glibc 2.27+
// (Szabolcs Nagy's N=128 scheme), mirroring the FMA-compiled variant
// this machine's libm dispatches op-for-op, so every lane performs the
// same double-precision operation sequence as one scalar libm call —
// bit-identical results, which byte-parity of the cluster outputs
// requires (tools/MatePairEM.cpp exponentials flow into emitted
// probabilities).
//
// Safety: the twin is only enabled after a one-time self-check proves
// bit-identity with the host libm over a domain-partition sweep
// (boundaries, subnormal results, specials, random fill).  Any
// mismatch (different libm build, non-x86 host, unexpected rounding
// mode) permanently disables it and the scalar std::exp loop runs
// instead.  Lanes outside the fast path (|x| >= 512, NaN/inf) fall
// back to scalar libm within the batch; x <= -746 short-circuits to
// +0.0 (exp underflows to zero well before -745.14).
// ---------------------------------------------------------------------

#if defined(__x86_64__)
#include <immintrin.h>
#define DT_VEXP_X86 1
#else
#define DT_VEXP_X86 0
#endif

namespace vexp {

// 2^(i/128) split into (tail, top-bits) pairs — the standard exp table
// from ARM optimized-routines math/exp_data.c (values verified against
// this host's libm at self-check time).
alignas(64) static const uint64_t kTab[256] = {
    0x0000000000000000ULL, 0x3ff0000000000000ULL, 0x3c9b3b4f1a88bf6eULL, 0x3feff63da9fb3335ULL,
    0xbc7160139cd8dc5dULL, 0x3fefec9a3e778061ULL, 0xbc905e7a108766d1ULL, 0x3fefe315e86e7f85ULL,
    0x3c8cd2523567f613ULL, 0x3fefd9b0d3158574ULL, 0xbc8bce8023f98efaULL, 0x3fefd06b29ddf6deULL,
    0x3c60f74e61e6c861ULL, 0x3fefc74518759bc8ULL, 0x3c90a3e45b33d399ULL, 0x3fefbe3ecac6f383ULL,
    0x3c979aa65d837b6dULL, 0x3fefb5586cf9890fULL, 0x3c8eb51a92fdeffcULL, 0x3fefac922b7247f7ULL,
    0x3c3ebe3d702f9cd1ULL, 0x3fefa3ec32d3d1a2ULL, 0xbc6a033489906e0bULL, 0x3fef9b66affed31bULL,
    0xbc9556522a2fbd0eULL, 0x3fef9301d0125b51ULL, 0xbc5080ef8c4eea55ULL, 0x3fef8abdc06c31ccULL,
    0xbc91c923b9d5f416ULL, 0x3fef829aaea92de0ULL, 0x3c80d3e3e95c55afULL, 0x3fef7a98c8a58e51ULL,
    0xbc801b15eaa59348ULL, 0x3fef72b83c7d517bULL, 0xbc8f1ff055de323dULL, 0x3fef6af9388c8deaULL,
    0x3c8b898c3f1353bfULL, 0x3fef635beb6fcb75ULL, 0xbc96d99c7611eb26ULL, 0x3fef5be084045cd4ULL,
    0x3c9aecf73e3a2f60ULL, 0x3fef54873168b9aaULL, 0xbc8fe782cb86389dULL, 0x3fef4d5022fcd91dULL,
    0x3c8a6f4144a6c38dULL, 0x3fef463b88628cd6ULL, 0x3c807a05b0e4047dULL, 0x3fef3f49917ddc96ULL,
    0x3c968efde3a8a894ULL, 0x3fef387a6e756238ULL, 0x3c875e18f274487dULL, 0x3fef31ce4fb2a63fULL,
    0x3c80472b981fe7f2ULL, 0x3fef2b4565e27cddULL, 0xbc96b87b3f71085eULL, 0x3fef24dfe1f56381ULL,
    0x3c82f7e16d09ab31ULL, 0x3fef1e9df51fdee1ULL, 0xbc3d219b1a6fbffaULL, 0x3fef187fd0dad990ULL,
    0x3c8b3782720c0ab4ULL, 0x3fef1285a6e4030bULL, 0x3c6e149289cecb8fULL, 0x3fef0cafa93e2f56ULL,
    0x3c834d754db0abb6ULL, 0x3fef06fe0a31b715ULL, 0x3c864201e2ac744cULL, 0x3fef0170fc4cd831ULL,
    0x3c8fdd395dd3f84aULL, 0x3feefc08b26416ffULL, 0xbc86a3803b8e5b04ULL, 0x3feef6c55f929ff1ULL,
    0xbc924aedcc4b5068ULL, 0x3feef1a7373aa9cbULL, 0xbc9907f81b512d8eULL, 0x3feeecae6d05d866ULL,
    0xbc71d1e83e9436d2ULL, 0x3feee7db34e59ff7ULL, 0xbc991919b3ce1b15ULL, 0x3feee32dc313a8e5ULL,
    0x3c859f48a72a4c6dULL, 0x3feedea64c123422ULL, 0xbc9312607a28698aULL, 0x3feeda4504ac801cULL,
    0xbc58a78f4817895bULL, 0x3feed60a21f72e2aULL, 0xbc7c2c9b67499a1bULL, 0x3feed1f5d950a897ULL,
    0x3c4363ed60c2ac11ULL, 0x3feece086061892dULL, 0x3c9666093b0664efULL, 0x3feeca41ed1d0057ULL,
    0x3c6ecce1daa10379ULL, 0x3feec6a2b5c13cd0ULL, 0x3c93ff8e3f0f1230ULL, 0x3feec32af0d7d3deULL,
    0x3c7690cebb7aafb0ULL, 0x3feebfdad5362a27ULL, 0x3c931dbdeb54e077ULL, 0x3feebcb299fddd0dULL,
    0xbc8f94340071a38eULL, 0x3feeb9b2769d2ca7ULL, 0xbc87deccdc93a349ULL, 0x3feeb6daa2cf6642ULL,
    0xbc78dec6bd0f385fULL, 0x3feeb42b569d4f82ULL, 0xbc861246ec7b5cf6ULL, 0x3feeb1a4ca5d920fULL,
    0x3c93350518fdd78eULL, 0x3feeaf4736b527daULL, 0x3c7b98b72f8a9b05ULL, 0x3feead12d497c7fdULL,
    0x3c9063e1e21c5409ULL, 0x3feeab07dd485429ULL, 0x3c34c7855019c6eaULL, 0x3feea9268a5946b7ULL,
    0x3c9432e62b64c035ULL, 0x3feea76f15ad2148ULL, 0xbc8ce44a6199769fULL, 0x3feea5e1b976dc09ULL,
    0xbc8c33c53bef4da8ULL, 0x3feea47eb03a5585ULL, 0xbc845378892be9aeULL, 0x3feea34634ccc320ULL,
    0xbc93cedd78565858ULL, 0x3feea23882552225ULL, 0x3c5710aa807e1964ULL, 0x3feea155d44ca973ULL,
    0xbc93b3efbf5e2228ULL, 0x3feea09e667f3bcdULL, 0xbc6a12ad8734b982ULL, 0x3feea012750bdabfULL,
    0xbc6367efb86da9eeULL, 0x3fee9fb23c651a2fULL, 0xbc80dc3d54e08851ULL, 0x3fee9f7df9519484ULL,
    0xbc781f647e5a3ecfULL, 0x3fee9f75e8ec5f74ULL, 0xbc86ee4ac08b7db0ULL, 0x3fee9f9a48a58174ULL,
    0xbc8619321e55e68aULL, 0x3fee9feb564267c9ULL, 0x3c909ccb5e09d4d3ULL, 0x3feea0694fde5d3fULL,
    0xbc7b32dcb94da51dULL, 0x3feea11473eb0187ULL, 0x3c94ecfd5467c06bULL, 0x3feea1ed0130c132ULL,
    0x3c65ebe1abd66c55ULL, 0x3feea2f336cf4e62ULL, 0xbc88a1c52fb3cf42ULL, 0x3feea427543e1a12ULL,
    0xbc9369b6f13b3734ULL, 0x3feea589994cce13ULL, 0xbc805e843a19ff1eULL, 0x3feea71a4623c7adULL,
    0xbc94d450d872576eULL, 0x3feea8d99b4492edULL, 0x3c90ad675b0e8a00ULL, 0x3feeaac7d98a6699ULL,
    0x3c8db72fc1f0eab4ULL, 0x3feeace5422aa0dbULL, 0xbc65b6609cc5e7ffULL, 0x3feeaf3216b5448cULL,
    0x3c7bf68359f35f44ULL, 0x3feeb1ae99157736ULL, 0xbc93091fa71e3d83ULL, 0x3feeb45b0b91ffc6ULL,
    0xbc5da9b88b6c1e29ULL, 0x3feeb737b0cdc5e5ULL, 0xbc6c23f97c90b959ULL, 0x3feeba44cbc8520fULL,
    0xbc92434322f4f9aaULL, 0x3feebd829fde4e50ULL, 0xbc85ca6cd7668e4bULL, 0x3feec0f170ca07baULL,
    0x3c71affc2b91ce27ULL, 0x3feec49182a3f090ULL, 0x3c6dd235e10a73bbULL, 0x3feec86319e32323ULL,
    0xbc87c50422622263ULL, 0x3feecc667b5de565ULL, 0x3c8b1c86e3e231d5ULL, 0x3feed09bec4a2d33ULL,
    0xbc91bbd1d3bcbb15ULL, 0x3feed503b23e255dULL, 0x3c90cc319cee31d2ULL, 0x3feed99e1330b358ULL,
    0x3c8469846e735ab3ULL, 0x3feede6b5579fdbfULL, 0xbc82dfcd978e9db4ULL, 0x3feee36bbfd3f37aULL,
    0x3c8c1a7792cb3387ULL, 0x3feee89f995ad3adULL, 0xbc907b8f4ad1d9faULL, 0x3feeee07298db666ULL,
    0xbc55c3d956dcaebaULL, 0x3feef3a2b84f15fbULL, 0xbc90a40e3da6f640ULL, 0x3feef9728de5593aULL,
    0xbc68d6f438ad9334ULL, 0x3feeff76f2fb5e47ULL, 0xbc91eee26b588a35ULL, 0x3fef05b030a1064aULL,
    0x3c74ffd70a5fddcdULL, 0x3fef0c1e904bc1d2ULL, 0xbc91bdfbfa9298acULL, 0x3fef12c25bd71e09ULL,
    0x3c736eae30af0cb3ULL, 0x3fef199bdd85529cULL, 0x3c8ee3325c9ffd94ULL, 0x3fef20ab5fffd07aULL,
    0x3c84e08fd10959acULL, 0x3fef27f12e57d14bULL, 0x3c63cdaf384e1a67ULL, 0x3fef2f6d9406e7b5ULL,
    0x3c676b2c6c921968ULL, 0x3fef3720dcef9069ULL, 0xbc808a1883ccb5d2ULL, 0x3fef3f0b555dc3faULL,
    0xbc8fad5d3ffffa6fULL, 0x3fef472d4a07897cULL, 0xbc900dae3875a949ULL, 0x3fef4f87080d89f2ULL,
    0x3c74a385a63d07a7ULL, 0x3fef5818dcfba487ULL, 0xbc82919e2040220fULL, 0x3fef60e316c98398ULL,
    0x3c8e5a50d5c192acULL, 0x3fef69e603db3285ULL, 0x3c843a59ac016b4bULL, 0x3fef7321f301b460ULL,
    0xbc82d52107b43e1fULL, 0x3fef7c97337b9b5fULL, 0xbc892ab93b470dc9ULL, 0x3fef864614f5a129ULL,
    0x3c74b604603a88d3ULL, 0x3fef902ee78b3ff6ULL, 0x3c83c5ec519d7271ULL, 0x3fef9a51fbc74c83ULL,
    0xbc8ff7128fd391f0ULL, 0x3fefa4afa2a490daULL, 0xbc8dae98e223747dULL, 0x3fefaf482d8e67f1ULL,
    0x3c8ec3bc41aa2008ULL, 0x3fefba1bee615a27ULL, 0x3c842b94c3a9eb32ULL, 0x3fefc52b376bba97ULL,
    0x3c8a64a931d185eeULL, 0x3fefd0765b6e4540ULL, 0xbc8e37bae43be3edULL, 0x3fefdbfdad9cbe14ULL,
    0x3c77893b4d91cd9dULL, 0x3fefe7c1819e90d8ULL, 0x3c5305c14160cc89ULL, 0x3feff3c22b8f71f1ULL};

constexpr double kInvLn2N = 0x1.71547652b82fep+7;   // 128/ln2
constexpr double kShift = 0x1.8p52;
constexpr double kNegLn2hiN = -0x1.62e42fefa0000p-8;
constexpr double kNegLn2loN = -0x1.cf79abc9e3b3ap-47;
constexpr double kC2 = 0x1.ffffffffffdbdp-2;
constexpr double kC3 = 0x1.555555555543cp-3;
constexpr double kC4 = 0x1.55555cf172b91p-5;
constexpr double kC5 = 0x1.1111167a4d017p-7;

#if DT_VEXP_X86
// One 8-lane step of the main path (|x| in [2^-54, 512)).  Lane classes
// outside the fast set are patched afterwards by the caller.
__attribute__((target("avx512f,avx512dq")))
static inline __m512d exp8_main(__m512d x) {
  const __m512d invln2N = _mm512_set1_pd(kInvLn2N);
  const __m512d shift = _mm512_set1_pd(kShift);
  __m512d z = _mm512_fmadd_pd(invln2N, x, shift);
  __m512d kd = _mm512_sub_pd(z, shift);
  __m512i ki = _mm512_castpd_si512(z);
  __m512d r = _mm512_fmadd_pd(kd, _mm512_set1_pd(kNegLn2hiN), x);
  r = _mm512_fmadd_pd(kd, _mm512_set1_pd(kNegLn2loN), r);
  __m512i idx = _mm512_slli_epi64(_mm512_and_epi64(ki,
      _mm512_set1_epi64(0x7f)), 1);
  __m512i top = _mm512_slli_epi64(ki, 45);
  __m512d tail = _mm512_i64gather_pd(idx, (const double*)kTab, 8);
  __m512i tops = _mm512_i64gather_epi64(
      _mm512_add_epi64(idx, _mm512_set1_epi64(1)),
      (const long long*)kTab, 8);
  __m512i sbits = _mm512_add_epi64(tops, top);
  __m512d p1 = _mm512_fmadd_pd(_mm512_set1_pd(kC3), r,
                               _mm512_set1_pd(kC2));
  __m512d t3 = _mm512_add_pd(tail, r);
  __m512d r2 = _mm512_mul_pd(r, r);
  __m512d p2 = _mm512_fmadd_pd(r, _mm512_set1_pd(kC5),
                               _mm512_set1_pd(kC4));
  __m512d q = _mm512_fmadd_pd(p1, r2, t3);
  __m512d r4 = _mm512_mul_pd(r2, r2);
  __m512d tmp = _mm512_fmadd_pd(r4, p2, q);
  __m512d scale = _mm512_castsi512_pd(sbits);
  return _mm512_fmadd_pd(scale, tmp, scale);
}

// dst[i] = exp(src[i] - sub[i]) for n values (sub may be null),
// bit-identical to the scalar std::exp loop.
__attribute__((target("avx512f,avx512dq")))
static void exp_batch_avx512(double* dst, const double* src,
                             const double* sub, size_t n) {
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m512d x = _mm512_loadu_pd(src + i);
    if (sub) x = _mm512_sub_pd(x, _mm512_loadu_pd(sub + i));
    __m512i bits = _mm512_castpd_si512(x);
    __m512i abstop = _mm512_and_epi64(_mm512_srli_epi64(bits, 52),
                                      _mm512_set1_epi64(0x7ff));
    // fast: abstop in [0x3c9, 0x407]  (|x| in [2^-54, 512))
    __mmask8 m_fast = _mm512_cmple_epu64_mask(
        _mm512_sub_epi64(abstop, _mm512_set1_epi64(0x3c9)),
        _mm512_set1_epi64(0x3e));
    // tiny: abstop < 0x3c9 -> 1.0 + x (covers +-0 and subnormal x)
    __mmask8 m_tiny = _mm512_cmplt_epu64_mask(
        abstop, _mm512_set1_epi64(0x3c9));
    // hard underflow: x <= -746.0 -> +0.0 (exp rounds to zero below
    // ~-745.14; -746 leaves margin past the subnormal-result region)
    __mmask8 m_zero = _mm512_cmple_pd_mask(
        x, _mm512_set1_pd(-746.0));
    __m512d res = exp8_main(x);
    res = _mm512_mask_add_pd(res, m_tiny, _mm512_set1_pd(1.0), x);
    res = _mm512_mask_mov_pd(res, m_zero, _mm512_setzero_pd());
    __mmask8 m_done = (__mmask8)(m_fast | m_tiny | m_zero);
    if (__builtin_expect(m_done != 0xff, 0)) {
      alignas(64) double xs[8];
      alignas(64) double rs[8];
      _mm512_store_pd(xs, x);
      _mm512_store_pd(rs, res);
      for (int l = 0; l < 8; l++)
        if (!(m_done & (1 << l))) rs[l] = std::exp(xs[l]);
      res = _mm512_load_pd(rs);
    }
    _mm512_storeu_pd(dst + i, res);
  }
  for (; i < n; i++)
    dst[i] = std::exp(sub ? src[i] - sub[i] : src[i]);
}
#endif  // DT_VEXP_X86

// One-time self-check: domain-partition sweep comparing the twin with
// the host libm bit for bit.  Returns whether the vector path may run.
static bool enabled() {
#if DT_VEXP_X86
  static const bool ok = []() {
    if (!__builtin_cpu_supports("avx512f") ||
        !__builtin_cpu_supports("avx512dq"))
      return false;
    std::vector<double> args;
    // boundaries and specials (each +- a few ulps)
    const double edges[] = {0.0, -0.0, 0x1p-54, -0x1p-54, 512.0, -512.0,
                            1.0, -1.0, -40.0, -700.0, -708.4, -745.0,
                            -745.13321910194110842, -745.2, -746.0,
                            -760.0, -1000.0, -1075.0, 700.0, 709.78,
                            710.0, 1000.0,
                            std::numeric_limits<double>::infinity(),
                            -std::numeric_limits<double>::infinity(),
                            std::numeric_limits<double>::quiet_NaN(),
                            std::numeric_limits<double>::denorm_min(),
                            -std::numeric_limits<double>::denorm_min()};
    for (double e : edges) {
      for (int d = -4; d <= 4; d++) {
        double v = e;
        for (int s = 0; s < (d < 0 ? -d : d); s++)
          v = std::nextafter(v, d < 0 ? -kHuge : kHuge);
        args.push_back(v);
      }
    }
    // deterministic random fill across the EM-relevant range and wider
    uint64_t state = 0x9e3779b97f4a7c15ULL;
    auto rnd = [&]() {
      state ^= state << 13; state ^= state >> 7; state ^= state << 17;
      return state;
    };
    for (int t = 0; t < 200000; t++) {
      double u = (double)(rnd() >> 11) * 0x1p-53;  // [0,1)
      double span = (t % 3 == 0) ? 1600.0 : (t % 3 == 1 ? 80.0 : 2.0);
      args.push_back(u * span - span / 2.0);
    }
    // subnormal-result band, dense
    for (int t = 0; t < 20000; t++) {
      double u = (double)(rnd() >> 11) * 0x1p-53;
      args.push_back(-745.5 + u * 40.0);
    }
    std::vector<double> got(args.size());
    exp_batch_avx512(got.data(), args.data(), nullptr, args.size());
    for (size_t i = 0; i < args.size(); i++) {
      double want = std::exp(args[i]);
      if (std::memcmp(&want, &got[i], sizeof want) != 0) return false;
    }
    return true;
  }();
  return ok;
#else
  return false;
#endif
}

// Public entry: dst[i] = exp(src[i] - (sub ? sub[i] : 0)), always
// bit-identical to scalar std::exp; vectorized when the twin checks out.
static void exp_batch(double* dst, const double* src, const double* sub,
                      size_t n) {
#if DT_VEXP_X86
  if (enabled()) {
    exp_batch_avx512(dst, src, sub, n);
    return;
  }
#endif
  for (size_t i = 0; i < n; i++)
    dst[i] = std::exp(sub ? src[i] - sub[i] : src[i]);
}

}  // namespace vexp

// ---------------------------------------------------------------------
// AS 241 norminv + normal pdf (defuse_tpu/stats/normal.py contract)
// ---------------------------------------------------------------------

double poly8(const double* c, double x) {
  double v = c[7];
  for (int i = 6; i >= 0; i--) v = v * x + c[i];
  return v;
}

double norminv(double p) {
  static const double A[8] = {3.3871328727963666080, 1.3314166789178437745e2,
    1.9715909503065514427e3, 1.3731693765509461125e4, 4.5921953931549871457e4,
    6.7265770927008700853e4, 3.3430575583588128105e4, 2.5090809287301226727e3};
  static const double B[8] = {1.0, 4.2313330701600911252e1,
    6.8718700749205790830e2, 5.3941960214247511077e3, 2.1213794301586595867e4,
    3.9307895800092710610e4, 2.8729085735721942674e4, 5.2264952788528545610e3};
  static const double C[8] = {1.42343711074968357734, 4.63033784615654529590,
    5.76949722146069140550, 3.64784832476320460504, 1.27045825245236838258,
    2.41780725177450611770e-1, 2.27238449892691845833e-2,
    7.74545014278341407640e-4};
  static const double D[8] = {1.0, 2.05319162663775882187,
    1.67638483018380384940, 6.89767334985100004550e-1,
    1.48103976427480074590e-1, 1.51986665636164571966e-2,
    5.47593808499534494600e-4, 1.05075007164441684324e-9};
  static const double E[8] = {6.65790464350110377720, 5.46378491116411436990,
    1.78482653991729133580, 2.96560571828504891230e-1,
    2.65321895265761230930e-2, 1.24266094738807843860e-3,
    2.71155556874348757815e-5, 2.01033439929228813265e-7};
  static const double F[8] = {1.0, 5.99832206555887937690e-1,
    1.36929880922735805310e-1, 1.48753612908506148525e-2,
    7.86869131145613259100e-4, 1.84631831751005468180e-5,
    1.42151175831644588870e-7, 2.04426310338993978564e-15};
  if (p <= 0.0) return -kHuge;
  if (p >= 1.0) return kHuge;
  double q = p - 0.5;
  if (std::fabs(q) <= 0.425) {
    double r = 0.180625 - q * q;
    return q * poly8(A, r) / poly8(B, r);
  }
  double r = (q < 0.0) ? p : 1.0 - p;
  r = std::sqrt(-std::log(r));
  double value;
  if (r <= 5.0) {
    r -= 1.6;
    value = poly8(C, r) / poly8(D, r);
  } else {
    r -= 5.0;
    value = poly8(E, r) / poly8(F, r);
  }
  return (q < 0.0) ? -value : value;
}

double normalpdf(double x, double mu, double sigma) {
  double coeff = 1.0 / (sigma * std::sqrt(2.0 * M_PI));
  double dist = (x - mu) / sigma;
  return coeff * std::exp(-0.5 * dist * dist);
}

// ---------------------------------------------------------------------
// AS 136 Hartigan-Wong k-means (defuse_tpu/cluster/kmeans.py contract)
// ---------------------------------------------------------------------

struct KmnsState {
  int m, n, k;
  const double* a;  // column-major (m x n)
  std::vector<double> c;  // column-major (k x n)
  std::vector<int> ic1, ic2, nc, ncp, itran, live;
  std::vector<double> an1, an2, d;
  int indx = 0;
};

void optra(KmnsState& s) {
  const int m = s.m, n = s.n, k = s.k;
  for (int l = 0; l < k; l++)
    if (s.itran[l] == 1) s.live[l] = m + 1;
  for (int i = 0; i < m; i++) {
    s.indx++;
    int l1 = s.ic1[i], l2 = s.ic2[i], ll = l2;
    if (s.nc[l1] > 1) {
      if (s.ncp[l1] != 0) {
        double de = 0.0;
        for (int j = 0; j < n; j++) {
          double df = s.a[i + j * m] - s.c[l1 + j * k];
          de += df * df;
        }
        s.d[i] = de * s.an1[l1];
      }
      double da = 0.0;
      for (int j = 0; j < n; j++) {
        double db = s.a[i + j * m] - s.c[l2 + j * k];
        da += db * db;
      }
      double r2 = da * s.an2[l2];
      for (int l = 0; l < k; l++) {
        if ((i + 1 < s.live[l1] || i + 1 < s.live[l2]) && l != l1 &&
            l != ll) {
          double rr = r2 / s.an2[l];
          double dc = 0.0;
          for (int j = 0; j < n; j++) {
            double dd = s.a[i + j * m] - s.c[l + j * k];
            dc += dd * dd;
          }
          if (dc < rr) {
            r2 = dc * s.an2[l];
            l2 = l;
          }
        }
      }
      if (s.d[i] <= r2) {
        s.ic2[i] = l2;
      } else {
        s.indx = 0;
        s.live[l1] = m + i + 1;
        s.live[l2] = m + i + 1;
        s.ncp[l1] = i + 1;
        s.ncp[l2] = i + 1;
        double al1 = s.nc[l1], alw = al1 - 1.0;
        double al2 = s.nc[l2], alt = al2 + 1.0;
        for (int j = 0; j < n; j++) {
          s.c[l1 + j * k] = (s.c[l1 + j * k] * al1 - s.a[i + j * m]) / alw;
          s.c[l2 + j * k] = (s.c[l2 + j * k] * al2 + s.a[i + j * m]) / alt;
        }
        s.nc[l1]--;
        s.nc[l2]++;
        s.an2[l1] = alw / al1;
        s.an1[l1] = (alw > 1.0) ? alw / (alw - 1.0) : kHuge;
        s.an1[l2] = alt / al2;
        s.an2[l2] = alt / (alt + 1.0);
        s.ic1[i] = l2;
        s.ic2[i] = l1;
      }
    }
    if (s.indx == m) return;
  }
  for (int l = 0; l < k; l++) {
    s.itran[l] = 0;
    s.live[l] -= m;
  }
}

void qtran(KmnsState& s) {
  const int m = s.m, n = s.n, k = s.k;
  int icoun = 0, istep = 0;
  for (;;) {
    for (int i = 0; i < m; i++) {
      icoun++;
      istep++;
      int l1 = s.ic1[i], l2 = s.ic2[i];
      if (s.nc[l1] > 1) {
        if (istep <= s.ncp[l1]) {
          double da = 0.0;
          for (int j = 0; j < n; j++) {
            double db = s.a[i + j * m] - s.c[l1 + j * k];
            da += db * db;
          }
          s.d[i] = da * s.an1[l1];
        }
        if (istep < s.ncp[l1] || istep < s.ncp[l2]) {
          double r2 = s.d[i] / s.an2[l2];
          double dd = 0.0;
          for (int j = 0; j < n; j++) {
            double de = s.a[i + j * m] - s.c[l2 + j * k];
            dd += de * de;
          }
          if (dd < r2) {
            icoun = 0;
            s.indx = 0;
            s.itran[l1] = 1;
            s.itran[l2] = 1;
            s.ncp[l1] = istep + m;
            s.ncp[l2] = istep + m;
            double al1 = s.nc[l1], alw = al1 - 1.0;
            double al2 = s.nc[l2], alt = al2 + 1.0;
            for (int j = 0; j < n; j++) {
              s.c[l1 + j * k] =
                  (s.c[l1 + j * k] * al1 - s.a[i + j * m]) / alw;
              s.c[l2 + j * k] =
                  (s.c[l2 + j * k] * al2 + s.a[i + j * m]) / alt;
            }
            s.nc[l1]--;
            s.nc[l2]++;
            s.an2[l1] = alw / al1;
            s.an1[l1] = (alw > 1.0) ? alw / (alw - 1.0) : kHuge;
            s.an1[l2] = alt / al2;
            s.an2[l2] = alt / (alt + 1.0);
            s.ic1[i] = l2;
            s.ic2[i] = l1;
          }
        }
      }
      if (icoun == m) return;
    }
  }
}

// returns ifault; assignments in ic1 (0-based)
int kmns(const double* a, int m, int n, std::vector<double>& c, int k,
         std::vector<int>& ic1_out, int iter_max) {
  if (k <= 1 || m <= k) return 3;
  KmnsState s;
  s.m = m;
  s.n = n;
  s.k = k;
  s.a = a;
  s.c = c;
  s.ic1.assign(m, 0);
  s.ic2.assign(m, 0);
  for (int i = 0; i < m; i++) {
    double dt[2] = {0.0, 0.0};
    for (int il = 0; il < 2; il++)
      for (int j = 0; j < n; j++) {
        double da = a[i + j * m] - s.c[il + j * k];
        dt[il] += da * da;
      }
    if (dt[1] < dt[0]) {
      s.ic1[i] = 1;
      s.ic2[i] = 0;
      std::swap(dt[0], dt[1]);
    } else {
      s.ic1[i] = 0;
      s.ic2[i] = 1;
    }
    for (int l = 2; l < k; l++) {
      double db = 0.0;
      for (int j = 0; j < n; j++) {
        double dc = a[i + j * m] - s.c[l + j * k];
        db += dc * dc;
      }
      if (db < dt[1]) {
        if (dt[0] <= db) {
          dt[1] = db;
          s.ic2[i] = l;
        } else {
          dt[1] = dt[0];
          s.ic2[i] = s.ic1[i];
          dt[0] = db;
          s.ic1[i] = l;
        }
      }
    }
  }
  s.nc.assign(k, 0);
  std::fill(s.c.begin(), s.c.end(), 0.0);
  for (int i = 0; i < m; i++) {
    int l = s.ic1[i];
    s.nc[l]++;
    for (int j = 0; j < n; j++) s.c[l + j * k] += a[i + j * m];
  }
  for (int l = 0; l < k; l++)
    if (s.nc[l] == 0) return 1;
  s.an1.assign(k, 0.0);
  s.an2.assign(k, 0.0);
  s.ncp.assign(k, 0);
  s.itran.assign(k, 0);
  s.live.assign(k, 0);
  s.d.assign(m, 0.0);
  for (int l = 0; l < k; l++) {
    double aa = s.nc[l];
    for (int j = 0; j < n; j++) s.c[l + j * k] /= aa;
    s.an2[l] = aa / (aa + 1.0);
    s.an1[l] = (aa > 1.0) ? aa / (aa - 1.0) : kHuge;
    s.itran[l] = 1;
    s.ncp[l] = -1;
  }
  s.indx = 0;
  int ifault = 2;
  for (int ij = 0; ij < iter_max; ij++) {
    optra(s);
    if (s.indx == m) {
      ifault = 0;
      break;
    }
    qtran(s);
    if (k == 2) {
      ifault = 0;
      break;
    }
    std::fill(s.ncp.begin(), s.ncp.end(), 0);
  }
  ic1_out = s.ic1;
  return ifault;
}

// ---------------------------------------------------------------------
// Exact mate-pair mixture EM (defuse_tpu/cluster/matepair_em.py contract)
// ---------------------------------------------------------------------

struct EMInstance {
  std::vector<double> x, y, u;
};

class MatePairEMHost {
 public:
  MatePairEMHost(double mean, double stddev, double precision,
                 int min_cluster_size)
      : mean_(mean), stddev_(stddev), min_size_(min_cluster_size) {
    double xq = -stddev * norminv((1.0 - precision) / 2.0);
    min_probability_ = normalpdf(xq, 0.0, stddev);
  }

  // clusters as concatenated member lists + sizes
  void DoClustering(const EMInstance& inst,
                    std::vector<std::vector<int>>& clusters) {
    clusters.clear();
    n_ = (int)inst.x.size();
    if (n_ < min_size_) return;
    x_ = inst.x;
    y_ = inst.y;
    u_ = inst.u;
    s_.resize(n_);
    for (int t = 0; t < n_; t++) s_[t] = x_[t] + y_[t] + u_[t];

    // stable descending sorts
    std::vector<int> xo_order(n_), yo_order(n_);
    for (int i = 0; i < n_; i++) xo_order[i] = yo_order[i] = i;
    std::stable_sort(xo_order.begin(), xo_order.end(),
                     [&](int a, int b) { return x_[a] > x_[b]; });
    std::stable_sort(yo_order.begin(), yo_order.end(),
                     [&](int a, int b) { return y_[a] > y_[b]; });
    xo_.resize(n_);
    yo_.resize(n_);
    to_xo_.resize(n_);
    to_yo_.resize(n_);
    for (int s = 0; s < n_; s++) {
      xo_[s] = x_[xo_order[s]];
      to_xo_[xo_order[s]] = s;
      yo_[s] = y_[yo_order[s]];
      to_yo_[yo_order[s]] = s;
    }
    xo_inv_ = xo_order;
    yo_inv_ = yo_order;

    double min_bic = 0.0;
    bool min_bic_valid = false;
    int k_min_bic = 1;
    std::vector<double> best_a, best_b;
    for (k_ = 1; k_ <= std::min(kKMax, n_); k_++) {
      double ll;
      if (!ExpectationMaximization(ll)) continue;
      double bic = -2.0 * ll + k_ * 2.0 * std::log((double)n_);
      if (!min_bic_valid || bic < min_bic) {
        min_bic = bic;
        k_min_bic = k_;
        min_bic_valid = true;
        best_a = a_;
        best_b = b_;
      }
    }
    // the reference re-runs the EM at the winning K; the run is
    // deterministic, so restoring the snapshot it would reproduce is
    // bit-exact (and a failed-everywhere selection returns just like
    // the re-run would fail)
    if (!min_bic_valid) return;
    k_ = k_min_bic;
    a_ = std::move(best_a);
    b_ = std::move(best_b);
    for (int j = 0; j < k_; j++) {
      std::vector<int> cluster;
      for (int i = 0; i < n_; i++) {
        double prob = PairProbability(x_[i], y_[i], u_[i], a_[j], b_[j]);
        if (prob > min_probability_) cluster.push_back(i);
      }
      if ((int)cluster.size() >= min_size_)
        clusters.push_back(std::move(cluster));
    }
  }

  double PairProbability(double x, double y, double u, double a,
                         double b) const {
    return normalpdf(a + b - x - y, u, stddev_) *
           std::exp(-kLambda * std::max(0.0, x - a) -
                    kLambda * std::max(0.0, y - b));
  }

 private:
  // Exact M-step: maximize the responsibility-weighted log-likelihood of
  // one component over its breakpoint pair (a,b).  The objective is
  // piecewise linear in the exponential-slack term, so the maximum sits
  // at one of the "knots" where a or b crosses a data point; the knots
  // are enumerated by merging the x- and y-sorted cumulative
  // responsibility profiles.  The knot enumeration and reduction order
  // must match the Python oracle (matepair_em.py) event for event —
  // byte-level cluster parity depends on identical fp rounding, so the
  // merge structure mirrors the spec in tools/MatePairEM.cpp:192-325
  // even though the surrounding code does not.
  bool MaxLikelihood(const std::vector<double>& resp,
                     const std::vector<double>& resp_by_x,
                     const std::vector<double>& resp_by_y, double& a,
                     double& b) const {
    const int n = n_;
    double resp_total = 0.0;
    for (int t = 0; t < n; t++) resp_total += resp[t];
    if (resp_total == 0.0) return false;
    // responsibility-weighted sum of (x+y+u): the normal term's center
    double resp_wsum = 0.0;
    for (int t = 0; t < n; t++) resp_wsum += resp[t] * s_[t];
    const double s2 = stddev_ * stddev_;

    // Knots are candidate (a,b) positions; the slack value is the
    // cumulative responsibility mass inside the exponential-slack
    // region at that knot (the piecewise-linear slope contribution).
    // The objective's derivative is monotone along the knot walk, so
    // instead of materializing all ~2n knots, generate them lazily in
    // the same merge order (cum profiles as incremental prefix sums —
    // identical accumulation order, bit-exact) and stop at the first
    // knot whose slope turns positive.
    double fa = 0, fb = 0, fs = 0;  // chosen (current) knot
    double pa = 0, pb = 0, ps = 0;  // knot before it
    bool first_knot = true, started = false, done = false;
    auto process = [&](double A, double B, double S) {
      if (started) {
        pa = fa;
        pb = fb;
        ps = fs;
        first_knot = false;
      }
      started = true;
      fa = A;
      fb = B;
      fs = S;
      double slope =
          (resp_wsum - resp_total * (A + B)) / s2 + kLambda * S;
      if (slope > 0) done = true;
    };
    process(xo_[0], yo_[0], 0.0);
    int i = 0, j = 0;
    double cx = resp_by_x[0], cy = resp_by_y[0];
    while (!done && i < n && j < n) {
      if (i + 1 < n && xo_[i] == xo_[i + 1]) {
        i++;
        cx += resp_by_x[i];
        continue;
      }
      if (j + 1 < n && yo_[j] == yo_[j + 1]) {
        j++;
        cy += resp_by_y[j];
        continue;
      }
      if (cx == cy) {
        process(xo_[i], yo_[j], cx);
        if (!done && i + 1 < n && j + 1 < n)
          process(xo_[i + 1], yo_[j + 1], cx);
        i++;
        if (i < n) cx += resp_by_x[i];
        j++;
        if (j < n) cy += resp_by_y[j];
      } else if (cx < cy) {
        process(xo_[i], yo_[j], cx);
        if (!done && i + 1 < n) process(xo_[i + 1], yo_[j], cx);
        i++;
        if (i < n) cx += resp_by_x[i];
      } else {
        process(xo_[i], yo_[j], cy);
        if (!done && j + 1 < n) process(xo_[i], yo_[j + 1], cy);
        j++;
        if (j < n) cy += resp_by_y[j];
      }
    }
    double ab_sum = (resp_wsum + s2 * kLambda * fs) / resp_total;
    if (first_knot) {
      double min_a = fa;
      double max_a = ab_sum - fb;
      a = 0.5 * (min_a + max_a);
      b = ab_sum - a;
    } else if (fs != ps) {
      a = fa;
      b = fb;
    } else {
      // flat segment: center (a,b) within the feasible interval
      double min_a = std::max(fa, ab_sum - pb);
      double max_a = std::min(pa, ab_sum - fb);
      a = 0.5 * (min_a + max_a);
      b = ab_sum - a;
    }
    return true;
  }

  bool SelectKKZ(int k, std::vector<double>& A, std::vector<double>& B) {
    A.clear();
    B.clear();
    double l2max = x_[0] * y_[0];
    int imax = 0;
    for (int i = 1; i < n_; i++) {
      double l2 = x_[i] * y_[i];
      if (l2 > l2max) {
        imax = i;
        l2max = l2;
      }
    }
    A.push_back(x_[imax]);
    B.push_back(y_[imax]);
    std::vector<double> dist(n_);
    for (int i = 0; i < n_; i++) {
      double dx = x_[i] - A[0], dy = y_[i] - B[0];
      dist[i] = dx * dx + dy * dy;
    }
    while ((int)A.size() < k) {
      int ifar = 0;
      double far = dist[0];
      for (int i = 1; i < n_; i++)
        if (dist[i] > far) {
          far = dist[i];
          ifar = i;
        }
      if (far == 0.0) return false;
      A.push_back(x_[ifar]);
      B.push_back(y_[ifar]);
      for (int i = 0; i < n_; i++) {
        double dx = x_[i] - A.back(), dy = y_[i] - B.back();
        dist[i] = std::min(dist[i], dx * dx + dy * dy);
      }
    }
    return true;
  }

  void Exponents() const {
    // j-major flat scratch (reused across iterations); hoisting
    // a_[j]+b_[j] keeps the reference association ((a+b)-x)-y)-u
    exps_flat_.resize((size_t)k_ * n_);
    for (int j = 0; j < k_; j++) {
      const double aj = a_[j], bj = b_[j], ab = aj + bj;
      double* row = &exps_flat_[(size_t)j * n_];
      for (int i = 0; i < n_; i++) {
        double diff = (ab - x_[i] - y_[i] - u_[i]) / stddev_;
        row[i] = -0.5 * diff * diff -
                 kLambda * std::max(0.0, x_[i] - aj) -
                 kLambda * std::max(0.0, y_[i] - bj);
      }
    }
  }

  // One pass computing the log-likelihood at the current (a, b, w) AND
  // the next responsibilities from a single Exponents evaluation.
  // Bit-identical to evaluating them separately: the per-component
  // terms w_j*exp(e_ij - max_i) accumulate in the same j order into the
  // same normalizer, and r = term/norm matches (w*exp(..))/norm.
  // (Updating r_ on the iteration that turns out to converge is
  // invisible: r_ only feeds the next iteration's M-step.)
  double LogLikelihoodAndResponsibilities() {
    Exponents();
    // exponentiate the whole k x n scratch up front via the vectorized
    // exp twin (bit-identical values to the scalar std::exp calls the
    // loop below used to make; the accumulation order is unchanged)
    maxexp_.resize(n_);
    // row sweeps in ascending-j order (same max sequence per element as
    // the per-i column walk, contiguous accesses vectorize)
    std::memcpy(maxexp_.data(), exps_flat_.data(),
                (size_t)n_ * sizeof(double));
    for (int j = 1; j < k_; j++) {
      const double* row = &exps_flat_[(size_t)j * n_];
      double* m = maxexp_.data();
      for (int i = 0; i < n_; i++) m[i] = std::max(m[i], row[i]);
    }
    for (int j = 0; j < k_; j++) {
      double* row = &exps_flat_[(size_t)j * n_];
      vexp::exp_batch(row, row, maxexp_.data(), n_);
    }
    // scale each row by w_j in place and accumulate the normalizer in
    // ascending-j order — each lane reproduces the scalar
    // ``t = w*exp(..); sum += t`` stream exactly (the mul result is
    // stored, so no FMA contraction is possible), just vectorized over
    // i instead of looping j per i
    sums_.assign(n_, 0.0);
    for (int j = 0; j < k_; j++) {
      double* row = &exps_flat_[(size_t)j * n_];
      double* s = sums_.data();
      const double wj = w_[j];
      for (int i = 0; i < n_; i++) {
        double t = wj * row[i];
        row[i] = t;
        s[i] = s[i] + t;
      }
    }
    double LL = 0.0;
    bool valid = true;
    for (int i = 0; i < n_; i++) {
      if (sums_[i] == 0.0)
        valid = false;
      else if (valid)
        LL += std::log(sums_[i]) + maxexp_[i];
    }
    // responsibilities: the division is a pure elementwise pass (the
    // compiler vectorizes it; IEEE division is per-lane exact), the
    // permutation stores stay scalar
    for (int j = 0; j < k_; j++) {
      const double* t = &exps_flat_[(size_t)j * n_];
      double* rj = r_[j].data();
      const double* s = sums_.data();
      for (int i = 0; i < n_; i++) rj[i] = t[i] / s[i];
      double* rxj = rxo_[j].data();
      double* ryj = ryo_[j].data();
      for (int i = 0; i < n_; i++) {
        double r = rj[i];
        rxj[to_xo_[i]] = r;
        ryj[to_yo_[i]] = r;
      }
    }
    return valid ? LL : -std::numeric_limits<double>::max();
  }

  bool ExpectationMaximization(double& ll_out) {
    r_.assign(k_, std::vector<double>(n_, 0.0));
    rxo_.assign(k_, std::vector<double>(n_, 0.0));
    ryo_.assign(k_, std::vector<double>(n_, 0.0));
    w_.assign(k_, 0.0);
    a_.assign(k_, 0.0);
    b_.assign(k_, 0.0);
    long t0 = NowNs();
    if (k_ == 1 || k_ == n_) {
      for (int j = 0; j < k_; j++) {
        std::fill(r_[j].begin(), r_[j].end(), 1.0 / k_);
        std::fill(rxo_[j].begin(), rxo_[j].end(), 1.0 / k_);
        std::fill(ryo_[j].begin(), ryo_[j].end(), 1.0 / k_);
      }
    } else {
      std::vector<double> px, py;
      if (!SelectKKZ(k_, px, py)) return false;
      // kmns over (y, x) column-major layout
      std::vector<double> a_mat((size_t)n_ * 2);
      for (int i = 0; i < n_; i++) {
        a_mat[i] = y_[i];
        a_mat[i + n_] = x_[i];
      }
      std::vector<double> c_mat((size_t)k_ * 2);
      for (int j = 0; j < k_; j++) {
        c_mat[j] = py[j];
        c_mat[j + k_] = px[j];
      }
      std::vector<int> ic1;
      int ifault = kmns(a_mat.data(), n_, 2, c_mat, k_, ic1, kKMeansIter);
      if (ifault == 1 || ifault == 3) return false;
      for (int i = 0; i < n_; i++)
        for (int j = 0; j < k_; j++) {
          double v = (j == ic1[i]) ? 1.0 : 0.0;
          r_[j][i] = v;
          rxo_[j][to_xo_[i]] = v;
          ryo_[j][to_yo_[i]] = v;
        }
    }
    g_em_init_ns += NowNs() - t0;
    double last_ll = 0.0;
    bool last_valid = false;
    for (;;) {
      long tm = NowNs();
      for (int j = 0; j < k_; j++) {
        double a, b;
        if (MaxLikelihood(r_[j], rxo_[j], ryo_[j], a, b)) {
          a_[j] = a;
          b_[j] = b;
        }
      }
      for (int j = 0; j < k_; j++) {
        double nk = 0.0;
        for (int i = 0; i < n_; i++) nk += r_[j][i];
        w_[j] = nk / n_;
      }
      long te = NowNs();
      g_em_mstep_ns += te - tm;
      double ll = LogLikelihoodAndResponsibilities();
      g_em_estep_ns += NowNs() - te;
      if (last_valid && std::fabs(ll - last_ll) < kTolerance) break;
      if (last_valid && ll == -std::numeric_limits<double>::max())
        return false;
      last_ll = ll;
      last_valid = true;
    }
    ll_out = last_ll;
    return true;
  }

  double mean_, stddev_, min_probability_;
  int min_size_;
  int n_ = 0, k_ = 0;
  std::vector<double> x_, y_, u_, s_, xo_, yo_, w_, a_, b_;
  std::vector<int> to_xo_, to_yo_, xo_inv_, yo_inv_;
  std::vector<std::vector<double>> r_, rxo_, ryo_;
  mutable std::vector<double> exps_flat_;
  std::vector<double> maxexp_;
  std::vector<double> sums_;
};

}  // namespace

// ---------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------

extern "C" {

// Vectorized-exp twin introspection/testing: returns 1 when the AVX-512
// twin passed the bit-identity self-check (and will be used by the EM),
// 0 when the scalar path runs.  dt_exp_batch exposes the batch entry
// for tests: dst[i] = exp(src[i]), bit-identical to libm either way.
int dt_exp_twin_enabled() { return vexp::enabled() ? 1 : 0; }

void dt_exp_batch(double* dst, const double* src, long n) {
  vexp::exp_batch(dst, src, nullptr, (size_t)n);
}

// Cluster one bin-pair instance.  Outputs flattened member lists:
// out_members gets the concatenated member indices, out_sizes the
// per-cluster counts; returns the number of clusters (<= kmax).
// Buffers must hold kmax*n ints (members) and kmax ints (sizes).
int dt_em_cluster(const double* x, const double* y, const double* u, int n,
                  double frag_mean, double frag_std, double precision,
                  int min_cluster_size, int* out_members, int* out_sizes) {
  MatePairEMHost em(frag_mean, frag_std, precision, min_cluster_size);
  EMInstance inst;
  inst.x.assign(x, x + n);
  inst.y.assign(y, y + n);
  inst.u.assign(u, u + n);
  std::vector<std::vector<int>> clusters;
  em.DoClustering(inst, clusters);
  int pos = 0;
  for (size_t c = 0; c < clusters.size(); c++) {
    out_sizes[c] = (int)clusters[c].size();
    for (int m : clusters[c]) out_members[pos++] = m;
  }
  return (int)clusters.size();
}

// Batched, threaded variant: instances given by offsets into flat
// arrays.  out_members must hold kKMax * total points; out_sizes
// kKMax * n_instances; out_counts n_instances.
void dt_em_cluster_batch(const double* x, const double* y, const double* u,
                         const int64_t* offsets, int n_instances,
                         double frag_mean, double frag_std, double precision,
                         int min_cluster_size, int n_threads,
                         int* out_members, int64_t* member_offsets,
                         int* out_sizes, int* out_counts) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  auto work = [&](int t) {
    MatePairEMHost em(frag_mean, frag_std, precision, min_cluster_size);
    for (int idx = t; idx < n_instances; idx += n_threads) {
      int64_t lo = offsets[idx], hi = offsets[idx + 1];
      int n = (int)(hi - lo);
      EMInstance inst;
      inst.x.assign(x + lo, x + hi);
      inst.y.assign(y + lo, y + hi);
      inst.u.assign(u + lo, u + hi);
      std::vector<std::vector<int>> clusters;
      em.DoClustering(inst, clusters);
      out_counts[idx] = (int)clusters.size();
      int pos = (int)(member_offsets[idx]);
      for (size_t c = 0; c < clusters.size(); c++) {
        out_sizes[idx * kKMax + (int)c] = (int)clusters[c].size();
        for (int m : clusters[c]) out_members[pos++] = m;
      }
    }
  };
  for (int t = 0; t < n_threads; t++) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
}

// KKZ center selection over raw (x, y) arrays — the same algorithm as
// MatePairEMHost::SelectKKZ / the Python _select_kkz
// (defuse_tpu/cluster/matepair_em_batch.py): first-max ties, squared
// euclidean farthest-point, failure (false) when the farthest distance
// degenerates to zero.
static bool SeedKKZ(const double* x, const double* y, int n, int k,
                    std::vector<double>& ax, std::vector<double>& ay) {
  ax.clear();
  ay.clear();
  double l2max = x[0] * y[0];
  int imax = 0;
  for (int i = 1; i < n; i++) {
    double l2 = x[i] * y[i];
    if (l2 > l2max) {
      imax = i;
      l2max = l2;
    }
  }
  ax.push_back(x[imax]);
  ay.push_back(y[imax]);
  std::vector<double> dist(n);
  for (int i = 0; i < n; i++) {
    double dx = x[i] - ax[0], dy = y[i] - ay[0];
    dist[i] = dx * dx + dy * dy;
  }
  while ((int)ax.size() < k) {
    int ifar = 0;
    double far = dist[0];
    for (int i = 1; i < n; i++)
      if (dist[i] > far) {
        far = dist[i];
        ifar = i;
      }
    if (far == 0.0) return false;
    ax.push_back(x[ifar]);
    ay.push_back(y[ifar]);
    for (int i = 0; i < n; i++) {
      double dx = x[i] - ax.back(), dy = y[i] - ay.back();
      dist[i] = std::min(dist[i], dx * dx + dy * dy);
    }
  }
  return true;
}

// Batched EM seeding for the device driver's host preparation
// (defuse_tpu/cluster/matepair_em_batch.py::prepare_batch): per
// (instance, K) row, the KKZ + AS136 k-means one-hot assignment the
// Python _seed computes — identical math (same kmns twin, 1000-iter
// cap), threaded across rows.  X/Y are flat per-instance coordinates
// with inst_offsets (n_instances+1 entries); row r reads instance
// row_inst[r] at K = row_k[r] and writes its n assignments (values in
// [0, K)) at out_ic1[row_offsets[r]..], valid only when
// out_uniform[r] == 0.  out_uniform[r] == 1 marks the uniform-1/K
// seed rows: K == 1, K == n, degenerate KKZ geometry, or kmns ifault
// in {1, 3} — exactly the Python fallback set.
extern "C" void dt_em_seed_batch(const double* X, const double* Y,
                                 const int64_t* inst_offsets,
                                 const int* row_inst, const int* row_k,
                                 const int64_t* row_offsets, long n_rows,
                                 int n_threads, int* out_ic1,
                                 unsigned char* out_uniform) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  auto work = [&](int t) {
    std::vector<double> ax, ay, a_mat, c_mat;
    std::vector<int> ic1;
    for (long r = t; r < n_rows; r += n_threads) {
      int inst = row_inst[r];
      int64_t lo = inst_offsets[inst];
      int n = (int)(inst_offsets[inst + 1] - lo);
      int k = row_k[r];
      if (k == 1 || k == n || !SeedKKZ(X + lo, Y + lo, n, k, ax, ay)) {
        out_uniform[r] = 1;
        continue;
      }
      // kmns over (y, x) column-major layout, as the EM seeding does
      a_mat.resize((size_t)n * 2);
      for (int i = 0; i < n; i++) {
        a_mat[i] = Y[lo + i];
        a_mat[i + n] = X[lo + i];
      }
      c_mat.resize((size_t)k * 2);
      for (int j = 0; j < k; j++) {
        c_mat[j] = ay[j];
        c_mat[j + k] = ax[j];
      }
      int ifault = kmns(a_mat.data(), n, 2, c_mat, k, ic1, kKMeansIter);
      if (ifault == 1 || ifault == 3) {
        out_uniform[r] = 1;
        continue;
      }
      out_uniform[r] = 0;
      int* dst = out_ic1 + row_offsets[r];
      for (int i = 0; i < n; i++) dst[i] = ic1[i];
    }
  };
  for (int t = 0; t < n_threads; t++) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
}

// Greedy set cover (canonical lowest-id tie-break).  clusters given as
// flat member array + offsets; out_keep is a 0/1 mask per member slot.
static void SetCoverCore(const int* members, const int64_t* offsets,
                         int n_clusters, int64_t n_members_total,
                         int* out_keep);

void dt_setcover(const int* members, const int64_t* offsets,
                 int n_clusters, int64_t n_members_total, int* out_keep) {
  SetCoverCore(members, offsets, n_clusters, n_members_total, out_keep);
}

// Whole setcover stage file -> file (tools/setcover.cpp:30-110 +
// Parsers.cpp:86-170 semantics, byte-identical to the Python
// read/rewrite pair in cluster/setcover.py): parse cluster rows once,
// solve over the end-0 fragment lists indexed by cluster id, and emit
// the rows whose (cluster, fragment) is in the cover with cluster size
// >= min_cluster_size.  Returns kept row count, -1 on IO/parse error.
long dt_setcover_file(const char* in_path, const char* out_path,
                      long min_cluster_size) {
  std::string data;
  {
    std::ifstream in(in_path, std::ios::binary);
    if (!in.good()) return -1;
    std::ostringstream ss;
    ss << in.rdbuf();
    data = ss.str();
  }
  struct Row {
    int32_t cid;
    int32_t frag;
    int64_t start, len;
  };
  std::vector<Row> rows;
  rows.reserve(1 + data.size() / 48);
  int32_t max_cid = -1;
  std::vector<int64_t> counts;  // end-0 members per cid
  size_t pos = 0;
  std::vector<std::pair<int32_t, int32_t>> end0;  // (cid, frag) file order
  while (pos < data.size()) {
    size_t eol = data.find('\n', pos);
    size_t end = (eol == std::string::npos) ? data.size() : eol;
    const char* s = data.data() + pos;
    char* endp;
    long cid = strtol(s, &endp, 10);
    if (endp == s || *endp != '\t') return -1;
    long cend = strtol(endp + 1, &endp, 10);
    if (*endp != '\t') return -1;
    long frag = strtol(endp + 1, &endp, 10);
    rows.push_back({(int32_t)cid, (int32_t)frag, (int64_t)pos,
                    (int64_t)(end - pos + (eol != std::string::npos))});
    if (cid > max_cid) max_cid = cid;
    if (cend == 0) end0.emplace_back((int32_t)cid, (int32_t)frag);
    pos = end + 1;
  }
  int n_clusters = max_cid + 1;
  counts.assign(n_clusters + 1, 0);
  for (auto& cf : end0) counts[cf.first + 1]++;
  std::vector<int64_t> offsets(n_clusters + 1, 0);
  for (int c = 0; c < n_clusters; c++)
    offsets[c + 1] = offsets[c] + counts[c + 1];
  std::vector<int> members(end0.size());
  {
    std::vector<int64_t> cur(offsets.begin(), offsets.end() - 1);
    for (auto& cf : end0) members[cur[cf.first]++] = cf.second;
  }
  std::vector<int> keep(end0.size(), 0);
  SetCoverCore(members.data(), offsets.data(), n_clusters,
               (int64_t)end0.size(), keep.data());
  // per-cluster kept fragment sets (sorted vectors), dropping clusters
  // under min_cluster_size
  std::vector<std::vector<int32_t>> kept(n_clusters);
  for (int c = 0; c < n_clusters; c++) {
    auto& v = kept[c];
    for (int64_t i = offsets[c]; i < offsets[c + 1]; i++)
      if (keep[i]) v.push_back(members[i]);
    if ((long)v.size() < min_cluster_size)
      v.clear();
    else
      std::sort(v.begin(), v.end());
  }
  FILE* out = fopen(out_path, "wb");
  if (!out) return -1;
  std::string buf;
  buf.reserve(data.size() / 2 + 64);
  long n_kept = 0;
  for (const Row& r : rows) {
    const auto& v = kept[r.cid];
    if (std::binary_search(v.begin(), v.end(), r.frag)) {
      buf.append(data, (size_t)r.start, (size_t)r.len);
      n_kept++;
    }
  }
  size_t nw = fwrite(buf.data(), 1, buf.size(), out);
  if (fclose(out) != 0 || nw != buf.size()) return -1;
  return n_kept;
}

static void SetCoverCore(const int* members, const int64_t* offsets,
                         int n_clusters, int64_t n_members_total,
                         int* out_keep) {
  std::vector<int64_t> sizes(n_clusters);
  int max_element = -1;
  for (int c = 0; c < n_clusters; c++) {
    sizes[c] = offsets[c + 1] - offsets[c];
    for (int64_t i = offsets[c]; i < offsets[c + 1]; i++)
      max_element = std::max(max_element, members[i]);
  }
  std::vector<std::vector<int>> element_clusters(max_element + 1);
  for (int c = 0; c < n_clusters; c++)
    for (int64_t i = offsets[c]; i < offsets[c + 1]; i++)
      element_clusters[members[i]].push_back(c);
  std::vector<char> assigned(max_element + 1, 0);
  std::fill(out_keep, out_keep + n_members_total, 0);
  // (size, -cluster) max-heap via ordered set
  std::set<std::pair<int64_t, int64_t>> order;  // (size, -cluster)
  for (int c = 0; c < n_clusters; c++)
    order.insert({sizes[c], -(int64_t)c});
  while (!order.empty()) {
    auto it = std::prev(order.end());
    int64_t size = it->first;
    int c = (int)(-it->second);
    if (size == 0) break;
    order.erase(it);
    for (int64_t i = offsets[c]; i < offsets[c + 1]; i++) {
      int e = members[i];
      if (assigned[e]) continue;
      assigned[e] = 1;
      out_keep[i] = 1;
      for (int other : element_clusters[e]) {
        if (other == c) {
          sizes[other]--;
          continue;
        }
        order.erase({sizes[other], -(int64_t)other});
        sizes[other]--;
        order.insert({sizes[other], -(int64_t)other});
      }
    }
    sizes[c] = 0;
  }
}

// Align-region aggregation (scripts/get_align_regions.pl /
// defuse_tpu/pipeline/regions.py::align_regions_lines): per
// (cluster, end), first row's ref+strand, min start, max end, emitted
// in canonical ascending (cluster, end) order.  Byte-identical to the
// Python implementation (pinned by test).  Returns the number of
// emitted region rows, -1 on IO/parse error.
long dt_align_regions(const char* in_path, const char* out_path) {
  std::string data;
  {
    std::ifstream in(in_path, std::ios::binary);
    if (!in.good()) return -1;
    std::ostringstream ss;
    ss << in.rdbuf();
    data = ss.str();
  }
  struct Region {
    std::string ref;
    char strand;
    int64_t start, end;
  };
  std::unordered_map<uint64_t, Region> agg;
  std::vector<uint64_t> order;  // first-seen keys; sorted before emit
  size_t pos = 0;
  while (pos < data.size()) {
    size_t eol = data.find('\n', pos);
    size_t end = (eol == std::string::npos) ? data.size() : eol;
    if (end > pos) {
      const char* s = data.data() + pos;
      char* endp;
      long cid = strtol(s, &endp, 10);
      if (endp == s || *endp != '\t') return -1;
      long cend = strtol(endp + 1, &endp, 10);
      if (*endp != '\t') return -1;
      // skip fields 2..3 (fragment id, read end)
      const char* p = endp + 1;
      const char* lim = data.data() + end;
      for (int skip = 0; skip < 2; skip++) {
        p = (const char*)memchr(p, '\t', lim - p);
        if (!p) return -1;
        p++;
      }
      const char* ref_s = p;
      p = (const char*)memchr(p, '\t', lim - p);
      if (!p) return -1;
      std::string ref(ref_s, p - ref_s);
      p++;
      char strand = (*p == '+') ? '+' : '-';  // python: non-'+' -> '-'
      p = (const char*)memchr(p, '\t', lim - p);
      if (!p) return -1;
      long start = strtol(p + 1, &endp, 10);
      if (*endp != '\t') return -1;
      long stop = strtol(endp + 1, &endp, 10);
      uint64_t key = ((uint64_t)(uint32_t)cid << 32) | (uint32_t)cend;
      auto it = agg.find(key);
      if (it == agg.end()) {
        agg.emplace(key, Region{std::move(ref), strand, start, stop});
        order.push_back(key);
      } else {
        if (start < it->second.start) it->second.start = start;
        if (stop > it->second.end) it->second.end = stop;
      }
    }
    if (eol == std::string::npos) break;
    pos = eol + 1;
  }
  std::sort(order.begin(), order.end());
  std::string out;
  out.reserve(order.size() * 48);
  char buf[64];
  for (uint64_t key : order) {
    const Region& r = agg[key];
    snprintf(buf, sizeof buf, "%u\t%u\t", (uint32_t)(key >> 32),
             (uint32_t)key);
    out += buf;
    out += r.ref;
    out += '\t';
    out += r.strand;
    snprintf(buf, sizeof buf, "\t%lld\t%lld\n", (long long)r.start,
             (long long)r.end);
    out += buf;
  }
  std::string tmp = std::string(out_path) + ".tmp";
  {
    std::ofstream of(tmp, std::ios::binary | std::ios::trunc);
    if (!of.good()) return -1;
    of.write(out.data(), (std::streamsize)out.size());
    if (!of.good()) return -1;
  }
  if (rename(tmp.c_str(), out_path) != 0) return -1;
  return (long)order.size();
}

}  // extern "C"

// ---------------------------------------------------------------------
// Full clustermatepairs stage: compact alignment file -> cluster rows
// file.  Mirrors defuse_tpu/cluster/discordant.py (itself pinned to the
// golden build of the reference): concordance screen, 32kb packed
// binning, per-bin-pair filters, exact EM, canonical ordering.
// ---------------------------------------------------------------------

namespace {

constexpr int kBinLength = 1 << 15;

inline int64_t TruncDiv(int64_t a, int64_t b) {
  int64_t q = (a < 0 ? -a : a) / b;
  return a < 0 ? -q : q;
}

struct PackedAln {
  uint32_t read_id;
  uint16_t rel_start;
  uint16_t rel_end;
};

struct CompactRow {
  int32_t fragment;
  int8_t read_end;
  int32_t ref;
  int8_t strand;
  int32_t start;
  int32_t end;
};

struct BinPairData {
  std::vector<PackedAln> first, second;
};

struct ClusterRowOut {
  int frag, read_end1, start1, end1, read_end2, start2, end2;
};

struct BinPairResult {
  // per cluster: rows (end0+end1 fused)
  std::vector<std::vector<ClusterRowOut>> clusters;
  int ref1, strand1, ref2, strand2;
};

void ProcessBinPair(uint32_t key1, uint32_t key2, const BinPairData& data,
                    int min_fusion_range, double frag_mean,
                    MatePairEMHost& em, int min_cluster_size,
                    BinPairResult& result) {
  auto unpack = [&](uint32_t key, const std::vector<PackedAln>& packed,
                    int& ref, int& strand, std::vector<int>& frag,
                    std::vector<int>& rend, std::vector<int>& start,
                    std::vector<int>& end) {
    ref = key & ((1u << 18) - 1);
    strand = (key >> 18) & 1;
    int bin = key >> 19;
    int64_t base = (int64_t)bin * kBinLength - kBinLength / 2;
    for (const auto& p : packed) {
      frag.push_back(p.read_id & 0x7FFFFFFF);
      rend.push_back((p.read_id >> 31) & 1);
      start.push_back((int)(p.rel_start + base));
      end.push_back((int)(p.rel_end + base));
    }
  };
  int ref1, strand1, ref2, strand2;
  std::vector<int> frag1, rend1, start1, end1;
  std::vector<int> frag2, rend2, start2, end2;
  unpack(key1, data.first, ref1, strand1, frag1, rend1, start1, end1);
  unpack(key2, data.second, ref2, strand2, frag2, rend2, start2, end2);
  result.ref1 = ref1;
  result.strand1 = strand1;
  result.ref2 = ref2;
  result.strand2 = strand2;

  std::map<int, std::vector<int>> frags1, frags2;
  for (size_t i = 0; i < frag1.size(); i++) frags1[frag1[i]].push_back(i);
  for (size_t i = 0; i < frag2.size(); i++) frags2[frag2[i]].push_back(i);

  // keep common fragments only
  std::vector<int> common;
  for (auto& kv : frags1)
    if (frags2.count(kv.first)) common.push_back(kv.first);
  if ((int)common.size() < min_cluster_size) {
    // size check happens later on filtered maps; mirror python: first
    // intersect, then overlap-filter, then size check
  }

  auto filter_overlapping = [&](std::vector<int>& aligns, int ref,
                                int strand, const std::vector<int>& starts,
                                const std::vector<int>& ends,
                                const std::vector<int>& rends) {
    std::vector<int> kept;
    std::set<std::pair<int64_t, int64_t>> seen[2];
    int64_t refstrand = (int64_t)ref | ((int64_t)strand << 31);
    for (int ai : aligns) {
      int64_t lo = TruncDiv(starts[ai], min_fusion_range);
      int64_t hi = TruncDiv(ends[ai], min_fusion_range);
      int e = rends[ai];
      bool overlap = false;
      for (int64_t b = lo; b <= hi; b++)
        if (seen[e].count({refstrand, b})) overlap = true;
      if (!overlap) {
        for (int64_t b = lo; b <= hi; b++) seen[e].insert({refstrand, b});
        kept.push_back(ai);
      }
    }
    aligns.swap(kept);
  };

  std::map<int, std::vector<int>> f1, f2;
  for (int f : common) {
    f1[f] = frags1[f];
    f2[f] = frags2[f];
  }
  for (auto& kv : f1)
    filter_overlapping(kv.second, ref1, strand1, start1, end1, rend1);
  for (auto& kv : f2)
    filter_overlapping(kv.second, ref2, strand2, start2, end2, rend2);
  if ((int)f1.size() < min_cluster_size ||
      (int)f2.size() < min_cluster_size)
    return;

  std::vector<int> pa1, pa2, pfrag;
  for (int f : common)
    for (int a1 : f1[f])
      for (int a2 : f2[f]) {
        pa1.push_back(a1);
        pa2.push_back(a2);
        pfrag.push_back(f);
      }
  if (pa1.empty()) return;

  EMInstance inst;
  int n = (int)pa1.size();
  inst.x.resize(n);
  inst.y.resize(n);
  inst.u.resize(n);
  for (int i = 0; i < n; i++) {
    int a1 = pa1[i], a2 = pa2[i];
    double xs, xe, ys, ye;
    if (strand1 == 0) {
      xs = start1[a1];
      xe = end1[a1];
    } else {
      xs = -end1[a1];
      xe = -start1[a1];
    }
    if (strand2 == 0) {
      ys = start2[a2];
      ye = end2[a2];
    } else {
      ys = -end2[a2];
      ye = -start2[a2];
    }
    inst.x[i] = xe;
    inst.y[i] = ye;
    inst.u[i] = frag_mean - (xe - xs + 1) - (ye - ys + 1);
  }
  std::vector<std::vector<int>> clusters;
  em.DoClustering(inst, clusters);
  for (auto& cluster : clusters) {
    if ((int)cluster.size() < min_cluster_size) continue;
    std::set<int> seen_frags;
    std::vector<ClusterRowOut> rows;
    for (int m : cluster) {
      int f = pfrag[m];
      if (seen_frags.count(f)) continue;
      seen_frags.insert(f);
      int a1 = pa1[m], a2 = pa2[m];
      rows.push_back({f, rend1[a1], start1[a1], end1[a1], rend2[a2],
                      start2[a2], end2[a2]});
    }
    if (!rows.empty()) result.clusters.push_back(std::move(rows));
  }
}

}  // namespace

// Full clustering driver.  part/n_parts partition the canonical
// (ascending bin-pair key) item sequence round-robin across ranks of a
// distributed run: rank r processes items with index ≡ r (mod
// n_parts) and, when sidecar_path is given, records one line per owned
// item — the number of clusters it produced — so the rank-0 merge can
// interleave the per-rank cluster groups back into the exact global
// canonical order and renumber sequentially (byte-identical to the
// single-process output; see parallel/shard.py merge_cluster_parts).
static int ClusterMatePairsImpl(const char* in_path, const char* out_path,
                                const char* sidecar_path,
                                double frag_mean, double frag_std,
                                double precision, int min_cluster_size,
                                int n_threads, int part, int n_parts) {
  const bool timing = getenv("DT_TIMING") != nullptr;
  auto tick = std::chrono::steady_clock::now();
  auto mark = [&](const char* stage) {
    if (!timing) return;
    auto now = std::chrono::steady_clock::now();
    fprintf(stderr, "[dt_cluster] %s: %.3fs\n", stage,
            std::chrono::duration<double>(now - tick).count());
    if (strcmp(stage, "em") == 0)
      fprintf(stderr,
              "[dt_cluster]   em thread-s: init %.3f mstep %.3f "
              "estep %.3f\n",
              g_em_init_ns.load() / 1e9, g_em_mstep_ns.load() / 1e9,
              g_em_estep_ns.load() / 1e9);
    tick = now;
  };
  const int min_fusion_range = (int)(frag_mean + 10.0 * frag_std);
  std::string data;
  {
    std::ifstream in(in_path, std::ios::binary);
    if (!in.good()) return 1;
    std::ostringstream ss;
    ss << in.rdbuf();
    data = ss.str();
  }

  std::unordered_map<std::string, int> ref_index;
  std::vector<std::string> ref_names;
  std::vector<CompactRow> rows;
  rows.reserve(1 + data.size() / 40);
  // zero-copy line walk; consecutive rows usually alternate between the
  // two refs of a fragment, so a 2-entry MRU memcmp check skips the
  // hash + temporary-string lookup on almost every row
  const char* p = data.data();
  const char* dend = p + data.size();
  int mru[2] = {-1, -1};
  while (p < dend) {
    const char* eol = (const char*)memchr(p, '\n', dend - p);
    if (!eol) eol = dend;
    // fields: fragment, readEnd(parser flip: "1"->0 else 1), ref,
    // strand, start, end
    char* endp;
    long fragment = strtol(p, &endp, 10);
    const char* f1 = endp + 1;
    const char* t1 = (const char*)memchr(f1, '\t', eol - f1);
    int read_end = (t1 - f1 == 1 && *f1 == '1') ? 0 : 1;
    const char* f2 = t1 + 1;
    const char* t2 = (const char*)memchr(f2, '\t', eol - f2);
    size_t rlen = (size_t)(t2 - f2);
    int ridx = -1;
    for (int m = 0; m < 2; m++) {
      int c = mru[m];
      if (c >= 0 && ref_names[c].size() == rlen &&
          memcmp(ref_names[c].data(), f2, rlen) == 0) {
        ridx = c;
        break;
      }
    }
    if (ridx < 0) {
      std::string ref(f2, rlen);
      auto ins = ref_index.insert({ref, (int)ref_names.size()});
      if (ins.second) ref_names.push_back(ref);
      ridx = ins.first->second;
    }
    if (ridx != mru[0]) {
      mru[1] = mru[0];
      mru[0] = ridx;
    }
    const char* f3 = t2 + 1;
    int strand = (*f3 == '-') ? 1 : 0;
    const char* f4 = (const char*)memchr(f3, '\t', eol - f3) + 1;
    long start = strtol(f4, &endp, 10);
    long end = strtol(endp + 1, nullptr, 10);
    rows.push_back({(int32_t)fragment, (int8_t)read_end,
                    (int32_t)ridx, (int8_t)strand,
                    (int32_t)start, (int32_t)end});
    p = eol + 1;
  }

  mark("parse");
  // group rows by fragment (stream order)
  std::vector<size_t> group_starts;
  for (size_t i = 0; i < rows.size();) {
    group_starts.push_back(i);
    size_t j = i;
    while (j < rows.size() && rows[j].fragment == rows[i].fragment) j++;
    i = j;
  }
  group_starts.push_back(rows.size());
  size_t n_groups = group_starts.size() - 1;

  if (n_threads < 1) n_threads = 1;
  int acc_threads = std::min<int>(n_threads, std::max<size_t>(1, n_groups));

  // concordance screen + binning, parallel over contiguous group chunks
  // (fragment order is preserved: chunk-order concatenation at merge).
  // Per-fragment scratch uses sorted small vectors instead of heap sets.
  std::vector<std::map<std::pair<uint32_t, uint32_t>, BinPairData>>
      accums(acc_threads);
  {
    std::vector<std::thread> acc_workers;
    for (int t = 0; t < acc_threads; t++) {
      acc_workers.emplace_back([&, t]() {
        size_t g_lo = n_groups * t / acc_threads;
        size_t g_hi = n_groups * (t + 1) / acc_threads;
        auto& bin_pairs = accums[t];
        std::vector<std::tuple<int32_t, int64_t, int8_t>> conc;
        std::vector<std::pair<uint32_t, PackedAln>> binned[2];
        for (size_t g = g_lo; g < g_hi; g++) {
          size_t i = group_starts[g], j = group_starts[g + 1];
          // concordance: both read ends share a (ref, range-bin)
          // (discordant.check_concordant / clustermatepairs.cpp:211-244)
          conc.clear();
          for (size_t r = i; r < j; r++) {
            int64_t lo = TruncDiv((int64_t)rows[r].start - min_fusion_range,
                                  min_fusion_range);
            int64_t hi = TruncDiv((int64_t)rows[r].end + min_fusion_range,
                                  min_fusion_range);
            for (int64_t b = lo; b <= hi; b++)
              conc.emplace_back(rows[r].ref, b, rows[r].read_end);
          }
          std::sort(conc.begin(), conc.end());
          bool concordant = false;
          for (size_t a = 0; a + 1 < conc.size() && !concordant; a++)
            if (std::get<0>(conc[a]) == std::get<0>(conc[a + 1]) &&
                std::get<1>(conc[a]) == std::get<1>(conc[a + 1]) &&
                std::get<2>(conc[a]) != std::get<2>(conc[a + 1]))
              concordant = true;
          if (concordant) continue;

          binned[0].clear();
          binned[1].clear();
          for (size_t r = i; r < j; r++) {
            int64_t lo = TruncDiv((int64_t)rows[r].start - min_fusion_range,
                                  kBinLength);
            int64_t hi = TruncDiv((int64_t)rows[r].end + min_fusion_range,
                                  kBinLength);
            uint32_t read_id = (uint32_t)rows[r].fragment |
                               ((uint32_t)rows[r].read_end << 31);
            for (int64_t b = lo; b <= hi; b++) {
              uint32_t key = (uint32_t)rows[r].ref |
                             ((uint32_t)rows[r].strand << 18) |
                             ((uint32_t)b << 19);
              int64_t base = b * kBinLength - kBinLength / 2;
              binned[rows[r].read_end].emplace_back(
                  key, PackedAln{read_id, (uint16_t)(rows[r].start - base),
                                 (uint16_t)(rows[r].end - base)});
            }
          }
          // group by key ascending, preserving append order within a key
          // (matches python dict-of-lists + sorted() iteration)
          auto by_key = [](const std::pair<uint32_t, PackedAln>& a,
                           const std::pair<uint32_t, PackedAln>& b) {
            return a.first < b.first;
          };
          std::stable_sort(binned[0].begin(), binned[0].end(), by_key);
          std::stable_sort(binned[1].begin(), binned[1].end(), by_key);
          for (size_t a1 = 0; a1 < binned[0].size();) {
            size_t b1 = a1;
            while (b1 < binned[0].size() &&
                   binned[0][b1].first == binned[0][a1].first)
              b1++;
            for (size_t a2 = 0; a2 < binned[1].size();) {
              size_t b2 = a2;
              while (b2 < binned[1].size() &&
                     binned[1][b2].first == binned[1][a2].first)
                b2++;
              uint32_t k1 = binned[0][a1].first, k2 = binned[1][a2].first;
              auto append = [&](std::vector<PackedAln>& dst, int e,
                                size_t lo2, size_t hi2) {
                for (size_t r = lo2; r < hi2; r++)
                  dst.push_back(binned[e][r].second);
              };
              if (k1 < k2) {
                auto& bp = bin_pairs[{k1, k2}];
                append(bp.first, 0, a1, b1);
                append(bp.second, 1, a2, b2);
              } else {
                auto& bp = bin_pairs[{k2, k1}];
                append(bp.first, 1, a2, b2);
                append(bp.second, 0, a1, b1);
              }
              a2 = b2;
            }
            a1 = b1;
          }
        }
      });
    }
    for (auto& th : acc_workers) th.join();
  }

  mark("accumulate");
  // merge thread accumulators in chunk order (ascending fragment order
  // within every bucket is preserved)
  std::map<std::pair<uint32_t, uint32_t>, BinPairData> bin_pairs;
  for (auto& acc : accums) {
    for (auto& kv : acc) {
      auto& bp = bin_pairs[kv.first];
      bp.first.insert(bp.first.end(), kv.second.first.begin(),
                      kv.second.first.end());
      bp.second.insert(bp.second.end(), kv.second.second.begin(),
                       kv.second.second.end());
    }
    acc.clear();
  }

  mark("merge");
  // process bin pairs (threaded, canonical order preserved on output)
  std::vector<const std::pair<const std::pair<uint32_t, uint32_t>,
                              BinPairData>*> items;
  for (const auto& kv : bin_pairs)
    if ((int)kv.second.first.size() >= min_cluster_size &&
        (int)kv.second.second.size() >= min_cluster_size)
      items.push_back(&kv);

  if (n_parts < 1) n_parts = 1;
  auto owned = [&](size_t idx) {
    return n_parts == 1 || (int)(idx % (size_t)n_parts) == part;
  };
  std::vector<BinPairResult> results(items.size());
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      MatePairEMHost em(frag_mean, frag_std, precision, min_cluster_size);
      for (size_t idx = t; idx < items.size(); idx += n_threads) {
        if (!owned(idx)) continue;
        ProcessBinPair(items[idx]->first.first, items[idx]->first.second,
                       items[idx]->second, min_fusion_range, frag_mean,
                       em, min_cluster_size, results[idx]);
      }
    });
  }
  for (auto& th : threads) th.join();

  mark("em");
  std::ofstream out(out_path);
  if (!out.good()) return 2;
  std::ofstream sidecar;
  if (sidecar_path) {
    sidecar.open(sidecar_path);
    if (!sidecar.good()) return 2;
  }
  int cluster_id = 0;
  char buf[256];
  for (size_t idx = 0; idx < results.size(); idx++) {
    if (!owned(idx)) continue;
    const auto& res = results[idx];
    if (sidecar_path) sidecar << res.clusters.size() << "\n";
    for (const auto& cluster : res.clusters) {
      for (const auto& row : cluster) {
        snprintf(buf, sizeof(buf), "%d\t0\t%d\t%d\t%s\t%c\t%d\t%d\n",
                 cluster_id, row.frag, row.read_end1,
                 ref_names[res.ref1].c_str(),
                 res.strand1 ? '-' : '+', row.start1, row.end1);
        out << buf;
        snprintf(buf, sizeof(buf), "%d\t1\t%d\t%d\t%s\t%c\t%d\t%d\n",
                 cluster_id, row.frag, row.read_end2,
                 ref_names[res.ref2].c_str(),
                 res.strand2 ? '-' : '+', row.start2, row.end2);
        out << buf;
      }
      cluster_id++;
    }
  }
  mark("output");
  return 0;
}

extern "C" {

int dt_clustermatepairs(const char* in_path, const char* out_path,
                        double frag_mean, double frag_std,
                        double precision, int min_cluster_size,
                        int n_threads) {
  return ClusterMatePairsImpl(in_path, out_path, nullptr, frag_mean,
                              frag_std, precision, min_cluster_size,
                              n_threads, 0, 1);
}

int dt_clustermatepairs_part(const char* in_path, const char* out_path,
                             const char* sidecar_path, double frag_mean,
                             double frag_std, double precision,
                             int min_cluster_size, int n_threads,
                             int part, int n_parts) {
  return ClusterMatePairsImpl(in_path, out_path, sidecar_path, frag_mean,
                              frag_std, precision, min_cluster_size,
                              n_threads, part, n_parts);
}

}  // extern "C"

// ---------------------------------------------------------------------
// Split-read realignment stages 2+3: screening DP + tie-column
// enumeration + row emission.  Exact integer recurrence pinned by
// defuse_tpu/align/split_dp.py (itself byte-parity vs the golden build
// of tools/SplitReadAligner.cpp); emission order and seen-split dedup
// mirror defuse_tpu/align/batch_realign.realign_candidates.
// ---------------------------------------------------------------------

namespace {

constexpr int kMatch = 2;
constexpr int kMismatch = -1;
constexpr int kGap = -2;
constexpr int kMinSplitScore = 8;  // MIN_ANCHOR(4) * MATCH(2)

// Streaming DP for read (q, n) vs ref (r, m) with rolling 2-row state:
// row 0 all zeros; row j: vert[0]=GAP*j, vert[i]=max(prev[i-1]+sub,
// prev[i]+GAP), col[i]=max(vert[i], col[i-1]+GAP).  Fills the anchored
// row maximum (clamped to 0 below kMinSplitScore) for rows 0..max_row
// and, for each row index listed ascending in capture (size n_capture),
// copies the full post-horizontal row into capture_out at the matching
// slot.  Rows past max_row are not computed.  The full DP table is
// never materialized — the working set is two rows (L1-resident),
// which is what makes the screening pass memory-cheap; arithmetic and
// iteration order are identical to the previous table-building version
// (byte parity pinned by tests/test_realign_driver.py and
// tests/test_split_chain_parity.py).
void SplitDPStream(const uint8_t* q, int n, const uint8_t* r, int m,
                   int max_row, int32_t* rowmax, const int* capture,
                   int n_capture, int32_t* capture_out,
                   std::vector<int32_t>& prevbuf,
                   std::vector<int32_t>& curbuf) {
  prevbuf.assign(m + 1, 0);
  curbuf.assign(m + 1, 0);
  int32_t* prev = prevbuf.data();
  int32_t* cur = curbuf.data();
  rowmax[0] = 0;  // row 0 max is 0 < kMinSplitScore
  int cap_idx = 0;
  if (n_capture > 0 && capture[0] == 0) {
    std::fill(capture_out, capture_out + (m + 1), 0);
    cap_idx++;
  }
  for (int j = 1; j <= max_row; j++) {
    uint8_t ch = q[j - 1];
    // vertical/diagonal candidates — vectorizes (no carried dependency)
    for (int i = 1; i <= m; i++) {
      int32_t sub = (r[i - 1] == ch) ? kMatch : kMismatch;
      cur[i] = std::max(prev[i - 1] + sub, prev[i] + kGap);
    }
    // horizontal-gap prefix max (serial scan); a gap-extended value is
    // always below its source so the row max can be tracked here free
    int32_t running = kGap * j;
    cur[0] = running;
    int32_t mx = running;
    for (int i = 1; i <= m; i++) {
      running = std::max(cur[i], running + kGap);
      cur[i] = running;
      mx = std::max(mx, running);
    }
    rowmax[j] = (mx >= kMinSplitScore) ? mx : 0;
    if (cap_idx < n_capture && capture[cap_idx] == j) {
      std::copy(cur, cur + (m + 1),
                capture_out + (size_t)cap_idx * (m + 1));
      cap_idx++;
    }
    std::swap(prev, cur);
  }
}

// Lane-parallel screening: kScreenLanes candidates advance together,
// one int32 SIMD lane each (16 x int32 = one AVX-512 vector, or two
// AVX2 vectors — GCC vector extensions lower to whatever the target
// has).  Sequences are pre-widened to int32 and interleaved
// col-major-by-lane (index i*kScreenLanes + l) so every step is a
// contiguous vector op with no cross-lane dependency; the serial
// horizontal-gap scan's dependency chain is amortized 16x.  The
// vertical/diagonal recurrence and the horizontal prefix scan are
// fused into one sweep (the scan consumes each cell as it is
// produced), and only the post-gap row is stored — per-lane
// arithmetic is identical to SplitDPStream (byte parity; pinned by
// tests/test_realign_driver.py, test_split_chain_parity.py).
// Pad codes: -1 for reads, -2 for refs — never equal to each other or
// to any real byte (0..255), so a shorter lane's padded columns only
// produce strictly decaying values that can never raise its row max,
// and its padded rows are simply never read out.
// One 64-byte vector register per step; the element type is chosen per
// call: int16 packs 32 lanes (DP values are bounded by +-2*(m+n), so
// any group with m+n <= 8000 provably fits) and int32 is the fallback
// for pathological lengths.  Per-lane arithmetic is identical integer
// math either way — results are bit-exact across element types.
typedef int32_t v16si __attribute__((vector_size(64)));
typedef int16_t v32hi __attribute__((vector_size(64)));
template <typename ET>
struct VTraits;
template <>
struct VTraits<int32_t> {
  typedef v16si V;
  static constexpr int W = 16;
};
template <>
struct VTraits<int16_t> {
  typedef v32hi V;
  static constexpr int W = 32;
};
constexpr int kScreenLanes = VTraits<int16_t>::W;  // max lanes (sizing)
template <typename ET>
static inline typename VTraits<ET>::V VLoad(const ET* p) {
  typename VTraits<ET>::V v;
  __builtin_memcpy(&v, p, sizeof(v));
  return v;
}
template <typename ET>
static inline void VStore(ET* p, typename VTraits<ET>::V v) {
  __builtin_memcpy(p, &v, sizeof(v));
}

// Per-lane capture request: after the horizontal pass of each row j,
// lanes whose (sorted ascending) rows list contains j get that row
// de-interleaved into out (nrows x (m_l+1), row-major).  next tracks
// the cursor into rows during the sweep.
struct LaneCapture {
  const int* rows = nullptr;
  int nrows = 0;
  int m_l = 0;
  int32_t* out = nullptr;
  int next = 0;
};

template <bool kCapture, typename ET>
void ScreenGroupSideT(const ET* q_il, int n_max, const ET* r_il,
                      int m_max, int32_t* rowmax /* lanes x (n_max+1) */,
                      std::vector<ET>& prevbuf,
                      std::vector<ET>& curbuf,
                      LaneCapture* caps = nullptr) {
  typedef typename VTraits<ET>::V VT;
  const int W = VTraits<ET>::W;
  prevbuf.assign((size_t)(m_max + 1) * W, 0);
  curbuf.assign((size_t)(m_max + 1) * W, 0);
  ET* prev = prevbuf.data();
  ET* cur = curbuf.data();
  for (int l = 0; l < W; l++) rowmax[(size_t)l * (n_max + 1)] = 0;
  if (kCapture) {
    for (int l = 0; l < W; l++) {
      LaneCapture& lc = caps[l];
      lc.next = 0;
      if (lc.nrows > 0 && lc.rows[0] == 0) {  // row 0 is all zeros
        std::fill(lc.out, lc.out + (lc.m_l + 1), 0);
        lc.next = 1;
      }
    }
  }
  for (int j = 1; j <= n_max; j++) {
    const VT qv = VLoad<ET>(q_il + (size_t)(j - 1) * W);
    const ET* __restrict__ rrow = r_il;
    const ET* __restrict__ prow = prev;
    ET* __restrict__ crow = cur;
    VT run, mx;
    for (int l = 0; l < W; l++) run[l] = (ET)(kGap * j);
    VStore<ET>(crow, run);
    mx = run;
    VT pd = VLoad<ET>(prow);  // prev[i-1] at i=1
    for (int i = 1; i <= m_max; i++) {
      VT rv = VLoad<ET>(rrow + (size_t)(i - 1) * W);
      VT pv = VLoad<ET>(prow + (size_t)i * W);
      VT eq = (rv == qv);  // -1 where equal
      VT sub = (eq & (ET)(kMatch - kMismatch)) + (ET)kMismatch;
      VT v = pd + sub;
      VT w = pv + (ET)kGap;
      VT c = (v > w) ? v : w;
      VT g = run + (ET)kGap;
      c = (c > g) ? c : g;
      run = c;
      VStore<ET>(crow + (size_t)i * W, c);
      mx = (mx > c) ? mx : c;
      pd = pv;
    }
    for (int l = 0; l < W; l++)
      rowmax[(size_t)l * (n_max + 1) + j] =
          (mx[l] >= kMinSplitScore) ? (int32_t)mx[l] : 0;
    if (kCapture) {
      for (int l = 0; l < W; l++) {
        LaneCapture& lc = caps[l];
        if (lc.next < lc.nrows && lc.rows[lc.next] == j) {
          int32_t* o = lc.out + (size_t)lc.next * (lc.m_l + 1);
          for (int i = 0; i <= lc.m_l; i++)
            o[i] = (int32_t)crow[(size_t)i * W + l];
          lc.next++;
        }
      }
    }
    std::swap(prev, cur);
  }
}

template <typename ET>
inline void ScreenGroupSide(const ET* q_il, int n_max,
                            const ET* r_il, int m_max, int32_t* rowmax,
                            std::vector<ET>& prevbuf,
                            std::vector<ET>& curbuf) {
  ScreenGroupSideT<false, ET>(q_il, n_max, r_il, m_max, rowmax, prevbuf,
                              curbuf);
}

// A screen survivor: candidate index + its winning split rows
// (ascending), held until the batched capture phase.
struct Survivor {
  int b;
  std::vector<int> ks;
};

// Output rows: (cand_idx, i1, j2, k, score) int32 x5.  Returns the total
// number of rows; if > cap, caller must re-invoke with a larger buffer.
template <typename ET>
static long SplitRealignImpl(const uint8_t* ref1, const int64_t* ref1_off,
                             const uint8_t* ref2, const int64_t* ref2_off,
                             const uint8_t* reads, const int64_t* read_off,
                             int n_cand, int n_threads, int32_t* out,
                             long cap) {
  std::vector<std::vector<int32_t>> results(n_cand);
  if (n_threads < 1) n_threads = 1;
  // group candidates of similar read/ref length so lane padding inside
  // a screen group is minimal; output order is by original index b, so
  // processing order is free
  const int W = VTraits<ET>::W;
  std::vector<int> order(n_cand);
  for (int b = 0; b < n_cand; b++) order[b] = b;
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    int64_t na = read_off[a + 1] - read_off[a];
    int64_t nb = read_off[b + 1] - read_off[b];
    if (na != nb) return na > nb;
    int64_t ma = std::max(ref1_off[a + 1] - ref1_off[a],
                          ref2_off[a + 1] - ref2_off[a]);
    int64_t mb = std::max(ref1_off[b + 1] - ref1_off[b],
                          ref2_off[b + 1] - ref2_off[b]);
    return ma > mb;
  });
  int n_groups = (n_cand + W - 1) / W;
  const bool timing = getenv("DEFUSE_REALIGN_TIMING") != nullptr;
  std::vector<double> t_screen(n_threads, 0), t_capture(n_threads, 0),
      t_prep(n_threads, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      auto now = [] {
        return std::chrono::duration<double>(
                   std::chrono::steady_clock::now().time_since_epoch())
            .count();
      };
      std::vector<ET> prevbuf, curbuf;
      std::vector<int32_t> cap1, cap2;
      std::vector<ET> q_il, qrev_il, r1_il, r2rev_il;
      std::vector<int32_t> grm1, grm2;
      std::vector<int> ks;
      std::vector<Survivor> survivors;
      for (int g = t; g < n_groups; g += n_threads) {
        int lo = g * W;
        int gn = std::min(W, n_cand - lo);
        int n_max = 0, m1_max = 0, m2_max = 0;
        for (int l = 0; l < gn; l++) {
          int b = order[lo + l];
          n_max = std::max<int>(n_max, (int)(read_off[b + 1] - read_off[b]));
          m1_max = std::max<int>(m1_max, (int)(ref1_off[b + 1] - ref1_off[b]));
          m2_max = std::max<int>(m2_max, (int)(ref2_off[b + 1] - ref2_off[b]));
        }
        if (n_max == 0) continue;
        double tp0 = timing ? now() : 0;
        // widened + interleaved sequences; -1/-2 pads never match
        q_il.assign((size_t)n_max * W, -1);
        qrev_il.assign((size_t)n_max * W, -1);
        r1_il.assign((size_t)m1_max * W, -2);
        r2rev_il.assign((size_t)m2_max * W, -2);
        for (int l = 0; l < gn; l++) {
          int b = order[lo + l];
          const uint8_t* q = reads + read_off[b];
          int n = (int)(read_off[b + 1] - read_off[b]);
          const uint8_t* r1 = ref1 + ref1_off[b];
          int m1 = (int)(ref1_off[b + 1] - ref1_off[b]);
          const uint8_t* r2 = ref2 + ref2_off[b];
          int m2 = (int)(ref2_off[b + 1] - ref2_off[b]);
          for (int j = 0; j < n; j++) {
            q_il[(size_t)j * W + l] = q[j];
            qrev_il[(size_t)j * W + l] = q[n - 1 - j];
          }
          for (int i = 0; i < m1; i++) r1_il[(size_t)i * W + l] = r1[i];
          for (int i = 0; i < m2; i++)
            r2rev_il[(size_t)i * W + l] = r2[m2 - 1 - i];
        }
        grm1.resize((size_t)W * (n_max + 1));
        grm2.resize((size_t)W * (n_max + 1));
        double ts0 = timing ? now() : 0;
        if (timing) t_prep[t] += ts0 - tp0;
        ScreenGroupSide(q_il.data(), n_max, r1_il.data(), m1_max,
                        grm1.data(), prevbuf, curbuf);
        ScreenGroupSide(qrev_il.data(), n_max, r2rev_il.data(), m2_max,
                        grm2.data(), prevbuf, curbuf);
        double ts1 = timing ? now() : 0;
        if (timing) t_screen[t] += ts1 - ts0;
        for (int l = 0; l < gn; l++) {
          int b = order[lo + l];
          int n = (int)(read_off[b + 1] - read_off[b]);
          if (n == 0) continue;
          const int32_t* rm1l = grm1.data() + (size_t)l * (n_max + 1);
          const int32_t* rm2l = grm2.data() + (size_t)l * (n_max + 1);
          int32_t min_score = (int32_t)((double)((float)n) *
                                        (double)((float)kMatch) * 0.90);
          int32_t max_score = 0;
          for (int k = 0; k <= n; k++) {
            int32_t tot = rm1l[k] + rm2l[n - k];
            if (tot >= min_score && tot > max_score) max_score = tot;
          }
          if (max_score <= 0) continue;
          // --- winning splits: rows needed for tie-column enumeration
          ks.clear();
          for (int k = 0; k <= n; k++) {
            int32_t tot = rm1l[k] + rm2l[n - k];
            if (tot < min_score || tot != max_score) continue;
            // anchored-max semantics — a side whose row max is below
            // threshold collects no columns
            if (rm1l[k] < kMinSplitScore || rm2l[n - k] < kMinSplitScore)
              continue;
            ks.push_back(k);
          }
          if (ks.empty()) continue;
          survivors.push_back({b, ks});
        }
        if (timing) t_capture[t] += now() - ts1;
      }
      // --- capture phase: survivors, re-grouped into fresh lane
      // batches, run through the same vector kernel with per-lane row
      // capture; winning rows are de-interleaved and tie columns
      // enumerated exactly as the scalar path would.
      double tc0 = timing ? now() : 0;
      int n_surv = (int)survivors.size();
      std::vector<LaneCapture> caps1(W), caps2(W);
      for (int s0 = 0; s0 < n_surv; s0 += W) {
        int gn = std::min(W, n_surv - s0);
        // per-side run length = max needed row over lanes
        int n1_run = 0, n2_run = 0, m1_max = 0, m2_max = 0;
        for (int l = 0; l < gn; l++) {
          const Survivor& sv = survivors[s0 + l];
          int b = sv.b;
          int n = (int)(read_off[b + 1] - read_off[b]);
          n1_run = std::max(n1_run, sv.ks.back());
          n2_run = std::max(n2_run, n - sv.ks.front());
          m1_max = std::max<int>(m1_max, (int)(ref1_off[b + 1] - ref1_off[b]));
          m2_max = std::max<int>(m2_max, (int)(ref2_off[b + 1] - ref2_off[b]));
        }
        q_il.assign((size_t)std::max(n1_run, 1) * W, -1);
        qrev_il.assign((size_t)std::max(n2_run, 1) * W, -1);
        r1_il.assign((size_t)std::max(m1_max, 1) * W, -2);
        r2rev_il.assign((size_t)std::max(m2_max, 1) * W, -2);
        size_t cap1_need = 0, cap2_need = 0;
        for (int l = 0; l < gn; l++) {
          const Survivor& sv = survivors[s0 + l];
          int b = sv.b;
          cap1_need += sv.ks.size() *
                       (size_t)(ref1_off[b + 1] - ref1_off[b] + 1);
          cap2_need += sv.ks.size() *
                       (size_t)(ref2_off[b + 1] - ref2_off[b] + 1);
        }
        cap1.resize(cap1_need);
        cap2.resize(cap2_need);
        std::vector<std::vector<int>> rows2_all(gn);
        size_t c1_off = 0, c2_off = 0;
        for (int l = 0; l < W; l++) {
          caps1[l] = LaneCapture{};
          caps2[l] = LaneCapture{};
        }
        for (int l = 0; l < gn; l++) {
          const Survivor& sv = survivors[s0 + l];
          int b = sv.b;
          const uint8_t* q = reads + read_off[b];
          int n = (int)(read_off[b + 1] - read_off[b]);
          const uint8_t* r1 = ref1 + ref1_off[b];
          int m1 = (int)(ref1_off[b + 1] - ref1_off[b]);
          const uint8_t* r2 = ref2 + ref2_off[b];
          int m2 = (int)(ref2_off[b + 1] - ref2_off[b]);
          for (int j = 0; j < n && j < n1_run; j++)
            q_il[(size_t)j * W + l] = q[j];
          for (int j = 0; j < n && j < n2_run; j++)
            qrev_il[(size_t)j * W + l] = q[n - 1 - j];
          for (int i = 0; i < m1; i++) r1_il[(size_t)i * W + l] = r1[i];
          for (int i = 0; i < m2; i++)
            r2rev_il[(size_t)i * W + l] = r2[m2 - 1 - i];
          rows2_all[l].clear();  // n-k ascending (ks descending)
          for (auto it = sv.ks.rbegin(); it != sv.ks.rend(); ++it)
            rows2_all[l].push_back(n - *it);
          caps1[l] = LaneCapture{sv.ks.data(), (int)sv.ks.size(), m1,
                                 cap1.data() + c1_off, 0};
          caps2[l] = LaneCapture{rows2_all[l].data(),
                                 (int)rows2_all[l].size(), m2,
                                 cap2.data() + c2_off, 0};
          c1_off += sv.ks.size() * (size_t)(m1 + 1);
          c2_off += sv.ks.size() * (size_t)(m2 + 1);
        }
        grm1.resize((size_t)W * (n1_run + 1));
        grm2.resize((size_t)W * (n2_run + 1));
        ScreenGroupSideT<true, ET>(q_il.data(), n1_run, r1_il.data(), m1_max,
                               grm1.data(), prevbuf, curbuf, caps1.data());
        ScreenGroupSideT<true, ET>(qrev_il.data(), n2_run, r2rev_il.data(),
                               m2_max, grm2.data(), prevbuf, curbuf,
                               caps2.data());
        for (int l = 0; l < gn; l++) {
          const Survivor& sv = survivors[s0 + l];
          int b = sv.b;
          int n = (int)(read_off[b + 1] - read_off[b]);
          int m1 = caps1[l].m_l, m2 = caps2[l].m_l;
          const int32_t* rm1l = grm1.data() + (size_t)l * (n1_run + 1);
          const int32_t* rm2l = grm2.data() + (size_t)l * (n2_run + 1);
          auto& res = results[b];
          std::set<std::pair<int, int>> seen_splits;
          for (size_t ki = 0; ki < sv.ks.size(); ki++) {
            int k = sv.ks[ki];
            int32_t s1 = rm1l[k], s2 = rm2l[n - k];
            const int32_t* row1 = caps1[l].out + ki * (size_t)(m1 + 1);
            // rows2 is ks reversed, so the slot for n-k counts from
            // the back
            size_t k2i = sv.ks.size() - 1 - ki;
            const int32_t* row2 = caps2[l].out + k2i * (size_t)(m2 + 1);
            int32_t sc = std::min(s1, s2);
            for (int i1 = 0; i1 <= m1; i1++) {
              if (row1[i1] != s1) continue;
              for (int i2 = 0; i2 <= m2; i2++) {
                if (row2[i2] != s2) continue;
                int j2 = m2 - i2 - 1;
                if (!seen_splits.insert({i1, j2}).second) continue;
                res.push_back(b);
                res.push_back(i1);
                res.push_back(j2);
                res.push_back(k);
                res.push_back(sc);
              }
            }
          }
        }
      }
      if (timing) t_capture[t] += now() - tc0;
    });
  }
  for (auto& th : threads) th.join();
  if (timing) {
    double sp = 0, ss = 0, sc = 0;
    for (int t = 0; t < n_threads; t++) {
      sp += t_prep[t];
      ss += t_screen[t];
      sc += t_capture[t];
    }
    fprintf(stderr,
            "[realign-timing] prep %.3fs screen %.3fs capture+enum %.3fs "
            "(thread-seconds)\n",
            sp, ss, sc);
  }
  long total = 0;
  for (const auto& res : results) total += (long)(res.size() / 5);
  if (total <= cap) {
    int32_t* p = out;
    for (const auto& res : results) {
      std::copy(res.begin(), res.end(), p);
      p += res.size();
    }
  }
  return total;
}

}  // namespace

extern "C" {

long dt_split_realign(const uint8_t* ref1, const int64_t* ref1_off,
                      const uint8_t* ref2, const int64_t* ref2_off,
                      const uint8_t* reads, const int64_t* read_off,
                      int n_cand, int n_threads, int32_t* out, long cap) {
  // 32-lane int16 vectors whenever every candidate's DP values provably
  // fit (|value| <= 2*(m+n)+2; see VTraits); int32 16-lane fallback for
  // pathological lengths.  Bit-exact either way.
  int64_t worst = 0;
  for (int b = 0; b < n_cand; b++) {
    int64_t n = read_off[b + 1] - read_off[b];
    int64_t m = std::max(ref1_off[b + 1] - ref1_off[b],
                         ref2_off[b + 1] - ref2_off[b]);
    worst = std::max(worst, m + n);
  }
  if (worst <= 8000)
    return SplitRealignImpl<int16_t>(ref1, ref1_off, ref2, ref2_off,
                                     reads, read_off, n_cand, n_threads,
                                     out, cap);
  return SplitRealignImpl<int32_t>(ref1, ref1_off, ref2, ref2_off, reads,
                                   read_off, n_cand, n_threads, out, cap);
}

}  // extern "C"

// ---------------------------------------------------------------------
// Candidate collection: stream the improper SAM against the binned mate
// regions and nominate split-read candidates in reference order.
// Contract: defuse_tpu/align/batch_realign.collect_candidates +
// align/tasks.BinnedLocations (SplitAlignment.cpp:177-303 semantics).
// ---------------------------------------------------------------------

namespace {

inline int64_t FloorDiv(int64_t a, int64_t b) {
  int64_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

}  // namespace

namespace {

// Core of candidate collection; appends (cluster_id, fragment,
// read_end, rev_comp) quads to res.  Returns 0 or a negative parse
// error code.
int CollectCandidatesCore(const char* sam_path,
                          const uint32_t* region_ids,
                          const int32_t* region_ref,
                          const int8_t* region_strand,
                          const int32_t* region_start,
                          const int32_t* region_end, long n_regions,
                          const char* ref_names_concat,
                          const int64_t* ref_name_off, int n_refs,
                          int bin_spacing, std::vector<int32_t>& res) {
  std::unordered_map<std::string, int> ref_index;
  for (int i = 0; i < n_refs; i++)
    ref_index.emplace(std::string(ref_names_concat + ref_name_off[i],
                                  ref_names_concat + ref_name_off[i + 1]),
                      i);

  // (strand, ref) -> bin -> region indices
  std::vector<std::unordered_map<int64_t, std::vector<int32_t>>> binned(2);
  for (long i = 0; i < n_regions; i++) {
    int64_t ref_key = region_ref[i];
    int64_t lo = FloorDiv(region_start[i], bin_spacing);
    int64_t hi = FloorDiv(region_end[i], bin_spacing);
    for (int64_t b = lo; b <= hi; b++)
      binned[region_strand[i]][(ref_key << 32) ^ (b & 0xFFFFFFFFll)]
          .push_back((int32_t)i);
  }

  // slurp once (single pread-sized read), then parse line chunks in
  // parallel: nomination per line is independent; the global
  // first-occurrence dedup is applied at the chunk-order merge, which
  // reproduces the sequential semantics exactly (chunk order = file
  // order)
  std::string data;
  {
    int fd = open(sam_path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) {
      close(fd);
      return -1;
    }
    data.resize((size_t)st.st_size);
    size_t got = 0;
    while (got < data.size()) {
      ssize_t r = read(fd, &data[got], data.size() - got);
      if (r <= 0) {
        close(fd);
        return -1;
      }
      got += (size_t)r;
    }
    close(fd);
  }
  int nt = (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 8) nt = 8;
  if (data.size() < (1 << 20)) nt = 1;
  // chunk boundaries on line starts
  std::vector<const char*> chunk_lo(nt + 1);
  const char* base = data.data();
  const char* dend = base + data.size();
  chunk_lo[0] = base;
  for (int t = 1; t < nt; t++) {
    const char* p = base + data.size() * t / nt;
    const char* nl = (const char*)memchr(p, '\n', dend - p);
    chunk_lo[t] = nl ? nl + 1 : dend;
  }
  chunk_lo[nt] = dend;

  std::vector<std::vector<int32_t>> partial(nt);
  std::vector<int> errs(nt, 0);
  auto worker = [&](int t) {
    const char* p0 = chunk_lo[t];
    const char* cend = chunk_lo[t + 1];
    auto& out = partial[t];
    std::vector<int32_t> hit_ids;
    while (p0 < cend) {
      const char* eol = (const char*)memchr(p0, '\n', dend - p0);
      if (!eol) eol = dend;
      const char* line_p = p0;
      p0 = eol + 1;
      if (eol == line_p || line_p[0] == '@') continue;
      // fields 0:qname 1:flag 2:rname 3:pos ... 9:seq
      const char* f[11];
      f[0] = line_p;
      int nf = 1;
      for (const char* p = line_p; p < eol && nf < 11; p++)
        if (*p == '\t') f[nf++] = p + 1;
      if (nf < 10) {
        errs[t] = -2;
        return;
      }
      const char* seq_end = (nf >= 11) ? f[10] - 1 : eol;
      if (f[2][0] == '*' && f[2][1] == '\t') continue;
      char* endp;
      long fragment = strtol(f[0], &endp, 10);
      long flag = strtol(f[1], nullptr, 10);
      int read_end_sam;
      if (*endp == '/') {
        char e = endp[1];
        if ((e != '1' && e != '2') || endp[2] != '\t') {
          errs[t] = -3;
          return;
        }
        read_end_sam = (e == '1') ? 0 : 1;
      } else {
        read_end_sam = (flag & 0x40) ? 0 : 1;
      }
      int strand = (flag & 0x10) ? 1 : 0;
      std::string rname(f[2], f[3] - f[2] - 1);
      auto it = ref_index.find(rname);
      if (it == ref_index.end()) continue;  // no regions on this ref
      int64_t ref_key = it->second;
      long pos = strtol(f[3], nullptr, 10);
      long seq_len = (long)(seq_end - f[9]);
      long aln_end = pos + seq_len - 1;

      hit_ids.clear();
      int64_t lo = FloorDiv(pos, bin_spacing);
      int64_t hi = FloorDiv(aln_end, bin_spacing);
      auto& bmap = binned[strand];
      for (int64_t b = lo; b <= hi; b++) {
        auto bit = bmap.find((ref_key << 32) ^ (b & 0xFFFFFFFFll));
        if (bit == bmap.end()) continue;
        for (int32_t ri : bit->second)
          if (region_start[ri] <= aln_end && region_end[ri] >= pos)
            hit_ids.push_back(ri);
      }
      if (hit_ids.empty()) continue;
      // unique ids, sorted by signed-int32 value of the packed id
      std::sort(hit_ids.begin(), hit_ids.end(),
                [&](int32_t a, int32_t b2) {
                  return (int32_t)region_ids[a] < (int32_t)region_ids[b2];
                });
      uint32_t prev_id = 0;
      bool first = true;
      for (int32_t ri : hit_ids) {
        uint32_t cid = region_ids[ri];
        if (!first && cid == prev_id) continue;
        first = false;
        prev_id = cid;
        uint32_t cluster_id = cid & 0x7FFFFFFF;
        int cluster_end = (cid >> 31) & 1;
        int read_end = (read_end_sam == 1) ? 0 : 1;
        int rev_comp = (cluster_end == 0) ? 1 : 0;
        out.push_back((int32_t)cluster_id);
        out.push_back((int32_t)fragment);
        out.push_back(read_end);
        out.push_back(rev_comp);
      }
    }
  };
  if (nt == 1) {
    worker(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; t++) ts.emplace_back(worker, t);
    for (auto& th : ts) th.join();
  }
  for (int t = 0; t < nt; t++)
    if (errs[t] < 0) return errs[t];
  // chunk-order merge with the global first-occurrence dedup
  std::unordered_map<uint32_t, std::unordered_set<uint64_t>> cand_unique;
  for (int t = 0; t < nt; t++) {
    const auto& out = partial[t];
    for (size_t i = 0; i + 3 < out.size(); i += 4) {
      uint32_t cluster_id = (uint32_t)out[i];
      uint64_t read_id = (uint64_t)(uint32_t)out[i + 1] |
                         ((uint64_t)(uint32_t)out[i + 2] << 31);
      uint64_t key = (read_id << 1) | (uint64_t)(uint32_t)out[i + 3];
      if (!cand_unique[cluster_id].insert(key).second) continue;
      res.push_back(out[i]);
      res.push_back(out[i + 1]);
      res.push_back(out[i + 2]);
      res.push_back(out[i + 3]);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

long dt_collect_candidates(const char* sam_path,
                           const uint32_t* region_ids,
                           const int32_t* region_ref,
                           const int8_t* region_strand,
                           const int32_t* region_start,
                           const int32_t* region_end, long n_regions,
                           const char* ref_names_concat,
                           const int64_t* ref_name_off, int n_refs,
                           int bin_spacing, int32_t* out, long cap) {
  std::vector<int32_t> res;
  int rc = CollectCandidatesCore(sam_path, region_ids, region_ref,
                                 region_strand, region_start, region_end,
                                 n_regions, ref_names_concat, ref_name_off,
                                 n_refs, bin_spacing, res);
  if (rc < 0) return rc;
  long total = (long)(res.size() / 4);
  if (total <= cap) std::copy(res.begin(), res.end(), out);
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Two-phase realign driver: phase 1 collects candidates and materializes
// their (possibly reverse-complemented) reads natively; the caller may
// run the device screen on the padded read matrix; phase 2 realigns the
// surviving candidates and writes the split-alignment rows file
// directly (SplitRow.format contract: 9 tab-terminated fields).
// ---------------------------------------------------------------------

namespace {

struct RealignDriver {
  std::vector<int32_t> cand;           // quads from CollectCandidatesCore
  std::vector<std::string> reads;      // per candidate, rev-comp applied
  std::vector<int32_t> flank_idx;      // per candidate -> unique flanks
  std::vector<std::string> flank1, flank2;
};

// async fastq read store: one loader thread per file (the /1 and /2 key
// spaces are disjoint), overlapping IO/parse with the clustering stage.
// Indexed mode defers all IO until the candidate set is known, then
// pread()s only the needed records through the .fqi offset index — at
// scale the realign driver touches a small fraction of the library, so
// this replaces a full two-file parse with a few thousand seeks.
struct ReadStoreHandle {
  std::thread th1, th2;
  std::unordered_map<uint32_t, std::string> reads1, reads2;
  bool ok1 = false, ok2 = false;
  bool indexed = false;
  std::string fq_path[2], fqi_path;
  // group mode (distributed tail): per-rank part stores with ascending
  // global fragment-id bases; candidate lookups dispatch to the owning
  // part with localized ids — no whole-library index is ever built
  std::vector<ReadStoreHandle*> parts;  // owned
  std::vector<int64_t> bases;
  ~ReadStoreHandle() {
    if (th1.joinable()) th1.join();
    if (th2.joinable()) th2.join();
    for (ReadStoreHandle* p : parts) delete p;
  }
};

bool LoadFastqReads(const char* path,
                    std::unordered_map<uint32_t, std::string>& reads) {
  std::ifstream in(path);
  if (!in.good()) return false;
  std::string header, seq, plus, qual;
  while (std::getline(in, header)) {
    if (!std::getline(in, seq) || !std::getline(in, plus) ||
        !std::getline(in, qual))
      return false;
    const char* h = header.c_str() + 1;
    char* endp;
    long fragment = strtol(h, &endp, 10);
    // name.rsplit("/",1): end 0 iff the suffix is exactly "1"
    int end = (endp[0] == '/' && endp[1] == '1' && endp[2] == '\0') ? 0 : 1;
    reads[(uint32_t)fragment | ((uint32_t)end << 31)] = std::move(seq);
  }
  return true;
}

// Selective load: fetch exactly the candidate (fragment, end) records
// from the renamed fastqs via the .fqi byte-offset index.  Sequences
// are byte-identical to a full LoadFastqReads pass (same files, same
// records); the parsed header is validated against the expected
// fragment id, which also disambiguates the fqi's offset==0 convention
// for missing ends (fragment 0's real offset is also 0).
bool SelectiveLoadReads(ReadStoreHandle& rh,
                        const std::vector<int32_t>& cand) {
  // mmap the index and both fastqs: record extraction is then pure
  // memory traffic riding the page cache (no syscall per record), so
  // the selective path beats the eager full parse at any candidate
  // density — dense candidate sets touch the same pages the eager
  // parse would, sparse ones touch almost none.
  struct Map {
    const char* p = nullptr;
    size_t n = 0;
    bool open(const char* path) {
      int fd = ::open(path, O_RDONLY);
      if (fd < 0) return false;
      struct stat st;
      if (fstat(fd, &st) != 0) {
        close(fd);
        return false;
      }
      if (st.st_size == 0) {
        close(fd);
        n = 0;
        return true;  // empty file is a valid (empty) map
      }
      p = (const char*)mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED,
                            fd, 0);
      close(fd);
      if (p == MAP_FAILED) {
        p = nullptr;
        return false;
      }
      n = (size_t)st.st_size;
      return true;
    }
    ~Map() {
      if (p) munmap((void*)p, n);
    }
  };
  Map fqi;
  if (!fqi.open(rh.fqi_path.c_str()) || fqi.n % 16 != 0) return false;
  // v2 header: original-backed ends carry arbitrary headers in their
  // (original) fastq, so the frag-id validation is skipped for them —
  // the index itself is the id mapping (built by the same scan that
  // assigned the ordinals)
  uint64_t backed_flags = 0;
  const char* tbl_base = fqi.p;
  size_t tbl_bytes = fqi.n;
  if (fqi.n >= 16 && memcmp(fqi.p, "DFQI2\0\0\0", 8) == 0) {
    memcpy(&backed_flags, fqi.p + 8, sizeof(backed_flags));
    tbl_base += 16;
    tbl_bytes -= 16;
  }
  long n_entries = (long)(tbl_bytes / 16);
  const int64_t* offs_tbl = (const int64_t*)tbl_base;

  std::vector<uint32_t> ids;
  ids.reserve(cand.size() / 4);
  for (size_t c = 0; c + 3 < cand.size(); c += 4)
    ids.push_back((uint32_t)cand[c + 1] |
                  ((uint32_t)cand[c + 2] << 31));
  std::sort(ids.begin(), ids.end());
  ids.erase(std::unique(ids.begin(), ids.end()), ids.end());

  // (read_id, record offset) work list via the fqi (offsets ascend with
  // the sorted ids, so each thread walks its file forward)
  std::vector<std::pair<uint32_t, int64_t>> work[2];
  for (uint32_t id : ids) {
    long frag = (long)(id & 0x7FFFFFFFu);
    int end = (int)(id >> 31);
    if (frag >= n_entries) continue;
    int64_t off = offs_tbl[2 * frag + end];
    if (off == 0 && frag != 0) continue;  // missing end
    work[end].emplace_back(id, off);
  }

  std::atomic<bool> ok{true};
  std::thread ts[2];
  for (int end = 0; end < 2; end++)
    ts[end] = std::thread([&, end]() {
      auto& out = end == 0 ? rh.reads1 : rh.reads2;
      Map fq;
      if (!fq.open(rh.fq_path[end].c_str()) || (!fq.p && fq.n == 0)) {
        if (!fq.p && !work[end].empty()) ok.store(false);
        return;
      }
      bool relaxed = (backed_flags >> end) & 1;
      for (auto& [id, off] : work[end]) {
        if (off < 0 || (size_t)off >= fq.n || fq.p[off] != '@') continue;
        const char* rec = fq.p + off;
        size_t avail = fq.n - (size_t)off;
        const char* nl1 = (const char*)memchr(rec, '\n', avail);
        if (!nl1) continue;
        const char* nl2 = (const char*)memchr(
            nl1 + 1, '\n', avail - (size_t)(nl1 + 1 - rec));
        if (!nl2) continue;
        if (!relaxed) {
          char* endp;
          long frag = strtol(rec + 1, &endp, 10);
          if (frag != (long)(id & 0x7FFFFFFFu) || endp[0] != '/' ||
              endp[1] != '1' + end)
            continue;  // stale/missing record
        }
        out[id].assign(nl1 + 1, nl2);
      }
    });
  ts[0].join();
  ts[1].join();
  rh.ok1 = rh.ok2 = ok.load();
  return rh.ok1;
}

// Group dispatch: split the candidate list per part store (localized
// fragment ids), selective-load each part through its own .fqi, then
// lift the sequences into the group maps keyed by GLOBAL id.  The
// distributed tail's replacement for building a whole-library index —
// each rank's frontend already indexed its own shard.
bool SelectiveLoadGroup(ReadStoreHandle& rh,
                        const std::vector<int32_t>& cand) {
  int np = (int)rh.parts.size();
  std::vector<std::vector<int32_t>> sub((size_t)np);
  for (size_t c = 0; c + 3 < cand.size(); c += 4) {
    int64_t frag = (int64_t)(uint32_t)cand[c + 1];
    int p = (int)(std::upper_bound(rh.bases.begin(), rh.bases.end(),
                                   frag) -
                  rh.bases.begin()) -
            1;
    if (p < 0 || p >= np) continue;
    sub[p].push_back(0);  // cluster id (unused by the loader)
    sub[p].push_back((int32_t)(frag - rh.bases[p]));
    sub[p].push_back(cand[c + 2]);
    sub[p].push_back(0);  // revcomp flag (unused by the loader)
  }
  bool ok = true;
  for (int p = 0; p < np && ok; p++) {
    ReadStoreHandle& part = *rh.parts[p];
    if (sub[p].empty()) continue;
    if (part.indexed) {
      ok = SelectiveLoadReads(part, sub[p]);
    } else {
      if (part.th1.joinable()) part.th1.join();
      if (part.th2.joinable()) part.th2.join();
      ok = part.ok1 && part.ok2;
    }
    if (!ok) break;
    for (int end = 0; end < 2; end++) {
      auto& src = end == 0 ? part.reads1 : part.reads2;
      auto& dst = end == 0 ? rh.reads1 : rh.reads2;
      for (auto& kv : src) {
        uint32_t gid =
            (uint32_t)((kv.first & 0x7FFFFFFFu) + (uint32_t)rh.bases[p]) |
            (kv.first & 0x80000000u);
        dst[gid] = std::move(kv.second);
      }
      src.clear();
    }
  }
  rh.ok1 = rh.ok2 = ok;
  return ok;
}

std::string RevComp(const std::string& s) {
  // tools/Common.cpp:32-54 semantics: case preserved, non-ACGT kept
  std::string out(s.rbegin(), s.rend());
  for (char& c : out) {
    switch (c) {
      case 'A': c = 'T'; break;
      case 'C': c = 'G'; break;
      case 'G': c = 'C'; break;
      case 'T': c = 'A'; break;
      case 'a': c = 't'; break;
      case 'c': c = 'g'; break;
      case 'g': c = 'c'; break;
      case 't': c = 'a'; break;
      default: break;
    }
  }
  return out;
}

}  // namespace

extern "C" {

// cluster_ids: n_clusters sorted ascending unique cluster ids, with
// flank sequences per cluster in the same order.
void* dt_reads_load(const char* fastq1, const char* fastq2) {
  auto* h = new ReadStoreHandle();
  std::string f1 = fastq1, f2 = fastq2;
  h->th1 = std::thread(
      [h, f1]() { h->ok1 = LoadFastqReads(f1.c_str(), h->reads1); });
  h->th2 = std::thread(
      [h, f2]() { h->ok2 = LoadFastqReads(f2.c_str(), h->reads2); });
  return h;
}

// Deferred .fqi-indexed read store: no IO until the driver knows its
// candidate set, then only those records are pread.  Returns null when
// the index file is absent (caller falls back to dt_reads_load).
void* dt_reads_index(const char* fastq1, const char* fastq2,
                     const char* fqi_path) {
  struct stat st;
  if (stat(fqi_path, &st) != 0 || st.st_size % 16 != 0) return nullptr;
  auto* h = new ReadStoreHandle();
  h->indexed = true;
  h->fq_path[0] = fastq1;
  h->fq_path[1] = fastq2;
  h->fqi_path = fqi_path;
  return h;
}

// Group store over per-rank part stores (distributed tail): candidate
// (fragment, end) lookups dispatch to the part owning the global id
// range starting at bases[i] (ascending).  Takes ownership of the part
// handles; free by passing the group wherever a store handle is freed.
void* dt_reads_group(void** handles, const int64_t* bases, int n) {
  if (n <= 0) return nullptr;
  auto* g = new ReadStoreHandle();
  for (int i = 0; i < n; i++) {
    if (!handles[i]) {
      g->parts.clear();  // never free caller handles on failure
      delete g;
      return nullptr;
    }
    g->parts.push_back((ReadStoreHandle*)handles[i]);
    g->bases.push_back(bases[i]);
  }
  return g;
}

// Free a read-store handle that will NOT be consumed by dt_driver_new
// (e.g. a partial group build).
void dt_reads_free(void* handle) {
  delete (ReadStoreHandle*)handle;
}

void* dt_driver_new(const char* sam_path, void* reads_handle,
                    const uint32_t* region_ids,
                    const int32_t* region_ref,
                    const int8_t* region_strand,
                    const int32_t* region_start,
                    const int32_t* region_end, long n_regions,
                    const char* ref_names_concat,
                    const int64_t* ref_name_off, int n_refs,
                    int bin_spacing, const uint32_t* cluster_ids,
                    long n_clusters, const char* flank1_concat,
                    const int64_t* flank1_off, const char* flank2_concat,
                    const int64_t* flank2_off) {
  auto* d = new RealignDriver();
  auto* rh = (ReadStoreHandle*)reads_handle;
  const bool timing = getenv("DEFUSE_REALIGN_TIMING") != nullptr;
  auto tick = std::chrono::steady_clock::now();
  auto mark = [&](const char* stage) {
    if (!timing) return;
    auto now = std::chrono::steady_clock::now();
    fprintf(stderr, "[driver-new] %s: %.3fs\n", stage,
            std::chrono::duration<double>(now - tick).count());
    tick = now;
  };
  if (CollectCandidatesCore(sam_path, region_ids, region_ref,
                            region_strand, region_start, region_end,
                            n_regions, ref_names_concat, ref_name_off,
                            n_refs, bin_spacing, d->cand) < 0) {
    delete rh;  // dtor joins any loader threads
    delete d;
    return nullptr;
  }
  mark("collect");
  if (!rh->parts.empty()) {
    if (!SelectiveLoadGroup(*rh, d->cand)) {
      delete rh;
      delete d;
      return nullptr;
    }
  } else if (rh->indexed) {
    if (!SelectiveLoadReads(*rh, d->cand)) {
      delete rh;
      delete d;
      return nullptr;
    }
  } else {
    rh->th1.join();
    rh->th2.join();
  }
  if (!rh->ok1 || !rh->ok2) {
    delete rh;
    delete d;
    return nullptr;
  }
  d->flank1.reserve(n_clusters);
  d->flank2.reserve(n_clusters);
  for (long i = 0; i < n_clusters; i++) {
    d->flank1.emplace_back(flank1_concat + flank1_off[i],
                           flank1_concat + flank1_off[i + 1]);
    d->flank2.emplace_back(flank2_concat + flank2_off[i],
                           flank2_concat + flank2_off[i + 1]);
  }
  long n_cand = (long)(d->cand.size() / 4);
  d->reads.reserve(n_cand);
  d->flank_idx.reserve(n_cand);
  static const std::string kEmpty;
  for (long c = 0; c < n_cand; c++) {
    uint32_t cluster_id = (uint32_t)d->cand[4 * c];
    uint32_t fragment = (uint32_t)d->cand[4 * c + 1];
    uint32_t read_end = (uint32_t)d->cand[4 * c + 2];
    int rev_comp = d->cand[4 * c + 3];
    uint32_t read_id = fragment | (read_end << 31);
    const std::string* seq = &kEmpty;
    auto it2 = rh->reads2.find(read_id);
    if (it2 != rh->reads2.end()) {
      seq = &it2->second;
    } else {
      auto it1 = rh->reads1.find(read_id);
      if (it1 != rh->reads1.end()) seq = &it1->second;
    }
    d->reads.push_back(rev_comp ? RevComp(*seq) : *seq);
    const uint32_t* lo = cluster_ids;
    const uint32_t* hi = cluster_ids + n_clusters;
    const uint32_t* pos = std::lower_bound(lo, hi, cluster_id);
    d->flank_idx.push_back(
        (pos != hi && *pos == cluster_id) ? (int32_t)(pos - lo) : -1);
  }
  mark("reads+revcomp");
  delete rh;  // reads consumed into the driver
  return d;
}

long dt_driver_n_candidates(void* handle) {
  return (long)(((RealignDriver*)handle)->cand.size() / 4);
}

// Padded read matrix for the device screen: out_reads (B x width) uint8
// zero-filled, out_lens (B,), out_flank_idx (B,).
void dt_driver_read_matrix(void* handle, uint8_t* out_reads,
                           int32_t* out_lens, int32_t* out_flank_idx,
                           int width) {
  auto* d = (RealignDriver*)handle;
  long n = (long)d->reads.size();
  for (long c = 0; c < n; c++) {
    const std::string& s = d->reads[c];
    int len = (int)std::min<size_t>(s.size(), width);
    std::memcpy(out_reads + (size_t)c * width, s.data(), len);
    out_lens[c] = len;
    out_flank_idx[c] = d->flank_idx[c];
  }
}

// Realign the (optionally screened) candidate set and materialize the
// formatted split rows.  Shared by dt_driver_emit (rows file only) and
// dt_driver_emit_eval (rows + sorted + breakpoint vote artifacts).
// Each row keeps its parsed fields alongside the formatted line.
struct EmittedRow {
  int32_t fid, i1, j2, k, lnk, score;
  std::string line;  // formatted incl. trailing "\t\n"
};

static long EmitRowsCore(RealignDriver* d, const uint8_t* survivors,
                         int n_threads, std::vector<EmittedRow>& out_rows) {
  long n_cand = (long)(d->cand.size() / 4);
  std::vector<int32_t> sel;
  for (long c = 0; c < n_cand; c++)
    if ((!survivors || survivors[c]) && d->flank_idx[c] >= 0 &&
        !d->reads[c].empty())
      sel.push_back((int32_t)c);

  // pack selected candidates through the existing realigner
  std::vector<int64_t> r1off(sel.size() + 1, 0), r2off(sel.size() + 1, 0),
      rdoff(sel.size() + 1, 0);
  std::string r1buf, r2buf, rdbuf;
  for (size_t i = 0; i < sel.size(); i++) {
    int32_t c = sel[i];
    const std::string& f1 = d->flank1[d->flank_idx[c]];
    const std::string& f2 = d->flank2[d->flank_idx[c]];
    r1buf += f1;
    r2buf += f2;
    rdbuf += d->reads[c];
    r1off[i + 1] = (int64_t)r1buf.size();
    r2off[i + 1] = (int64_t)r2buf.size();
    rdoff[i + 1] = (int64_t)rdbuf.size();
  }
  std::vector<int32_t> rows;
  rows.resize(16 * sel.size() + 64);
  long total = dt_split_realign(
      (const uint8_t*)r1buf.data(), r1off.data(),
      (const uint8_t*)r2buf.data(), r2off.data(),
      (const uint8_t*)rdbuf.data(), rdoff.data(), (int)sel.size(),
      n_threads, rows.data(), (long)(rows.size() / 5));
  if (total * 5 > (long)rows.size()) {
    rows.resize(total * 5);
    dt_split_realign((const uint8_t*)r1buf.data(), r1off.data(),
                     (const uint8_t*)r2buf.data(), r2off.data(),
                     (const uint8_t*)rdbuf.data(), rdoff.data(),
                     (int)sel.size(), n_threads, rows.data(), total);
  }
  out_rows.resize(total);
  char buf[256];
  for (long t = 0; t < total; t++) {
    int32_t ci = rows[5 * t], i1 = rows[5 * t + 1], j2 = rows[5 * t + 2],
            k = rows[5 * t + 3], score = rows[5 * t + 4];
    int32_t c = sel[ci];
    int ln = (int)d->reads[c].size();
    EmittedRow& er = out_rows[t];
    er.fid = d->cand[4 * c];
    er.i1 = i1;
    er.j2 = j2;
    er.k = k;
    er.lnk = ln - k;
    er.score = score;
    snprintf(buf, sizeof(buf),
             "%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t\n", er.fid,
             d->cand[4 * c + 1], d->cand[4 * c + 2], d->cand[4 * c + 3],
             i1, j2, k, er.lnk, score);
    er.line = buf;
  }
  return total;
}

// Realign candidates (survivors mask optional; NULL = all) and write
// the split rows file.  Returns the row count, or <0 on error.
long dt_driver_emit(void* handle, const uint8_t* survivors,
                    const char* out_path, int n_threads) {
  auto* d = (RealignDriver*)handle;
  std::vector<EmittedRow> rows;
  long total = EmitRowsCore(d, survivors, n_threads, rows);
  std::ofstream out(out_path);
  if (!out.good()) return -1;
  for (const EmittedRow& r : rows) out << r.line;
  return total;
}

// Full realign tail: emit + numeric-stable sort + per-fusion breakpoint
// vote and sequence reconstruction (SplitAlignment.cpp:484-594 /
// evalsplitalign.cpp:96-114 contract; byte-identical to the Python
// sort + align/tasks.py::evaluate_file chain).  Task metadata arrays
// are indexed like the cluster_ids list given to dt_driver_new; rem/ref
// concats carry 2 entries per cluster (offsets length 2n+1).  Returns
// the split row count, or <0 on error/unknown fusion id (the caller
// falls back to the Python path without trusting partial outputs).
long dt_driver_emit_eval(
    void* handle, const uint8_t* survivors, const char* out_path,
    const char* sorted_path, const char* seq_path, const char* break_path,
    const char* pred_path, int n_threads, const uint32_t* cluster_ids,
    long n_clusters, const char* rem_concat, const int64_t* rem_off,
    const int64_t* seq_start, const int64_t* seq_length,
    const int8_t* seq_strand, const char* refname_concat,
    const int64_t* refname_off, const int8_t* align_strand) {
  auto* d = (RealignDriver*)handle;
  // validate fusion-id lookups BEFORE the expensive realignment: every
  // selectable candidate (flank_idx >= 0 was itself derived from
  // cluster_ids at construction) must resolve, so a mismatched
  // cluster_ids array fails fast and the caller's Python fallback does
  // not pay for a wasted DP pass
  {
    long n_cand = (long)(d->cand.size() / 4);
    for (long c = 0; c < n_cand; c++) {
      if (d->flank_idx[c] < 0) continue;
      uint32_t fid = (uint32_t)d->cand[4 * c];
      const uint32_t* pos =
          std::lower_bound(cluster_ids, cluster_ids + n_clusters, fid);
      if (pos == cluster_ids + n_clusters || *pos != fid) return -1;
    }
  }
  std::vector<EmittedRow> rows;
  long total = EmitRowsCore(d, survivors, n_threads, rows);

  std::vector<int32_t> order(rows.size());
  for (size_t i = 0; i < rows.size(); i++) order[i] = (int32_t)i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    if (rows[a].fid != rows[b].fid) return rows[a].fid < rows[b].fid;
    return rows[a].line < rows[b].line;
  });

  std::string seq_buf, break_buf, pred_buf;
  char fbuf[512];
  for (size_t g = 0; g < order.size();) {
    size_t h = g;
    int32_t fid = rows[order[g]].fid;
    while (h < order.size() && rows[order[h]].fid == fid) h++;
    // task lookup (cluster_ids ascending)
    const uint32_t* lo = cluster_ids;
    const uint32_t* hi = cluster_ids + n_clusters;
    const uint32_t* pos = std::lower_bound(lo, hi, (uint32_t)fid);
    if (pos == hi || *pos != (uint32_t)fid) return -1;
    long ti = pos - lo;
    // vote: sum score per (i1, j2), best = strict max over ascending
    // split order
    std::map<std::pair<int32_t, int32_t>, int64_t> split_score;
    for (size_t t = g; t < h; t++) {
      const EmittedRow& r = rows[order[t]];
      split_score[{r.i1, r.j2}] += r.score;
    }
    int64_t max_score = -1;
    std::pair<int32_t, int32_t> best{0, 0};
    for (const auto& kv : split_score)
      if (kv.second > max_score) {
        best = kv.first;
        max_score = kv.second;
      }
    // sequence: rem1 + flank1[:i1] | flank2[j2+1:] + rem2
    const std::string& f1 = d->flank1[ti];
    const std::string& f2 = d->flank2[ti];
    std::string sequence;
    sequence.append(rem_concat + rem_off[2 * ti],
                    rem_concat + rem_off[2 * ti + 1]);
    sequence.append(f1, 0, (size_t)std::min<int64_t>(best.first,
                                                     (int64_t)f1.size()));
    sequence += '|';
    if ((size_t)(best.second + 1) < f2.size())
      sequence.append(f2, (size_t)(best.second + 1), std::string::npos);
    sequence.append(rem_concat + rem_off[2 * ti + 1],
                    rem_concat + rem_off[2 * ti + 2]);
    // breakpoint genome positions
    int64_t break_pos[2];
    if (seq_strand[2 * ti] == 0)
      break_pos[0] = seq_start[2 * ti] + best.first - 1;
    else
      break_pos[0] = seq_start[2 * ti] + seq_length[2 * ti] - best.first;
    if (seq_strand[2 * ti + 1] == 0)
      break_pos[1] = seq_start[2 * ti + 1] + best.second + 1;
    else
      break_pos[1] = seq_start[2 * ti + 1] + seq_length[2 * ti + 1] -
                     best.second - 2;
    // stats over kept rows in sorted order (oracle accumulation order)
    double pos_sum = 0.0, min_sum = 0.0;
    long n_kept = 0;
    for (size_t t = g; t < h; t++) {
      const EmittedRow& r = rows[order[t]];
      if (r.i1 != best.first || r.j2 != best.second) continue;
      pred_buf += r.line;
      n_kept++;
      const int kMinAnchor = 4;  // align/split_dp.py MIN_ANCHOR
      double pos_range = (double)(r.k + r.lnk - 2 * kMinAnchor);
      double pos_value = (double)std::max(0, r.k - kMinAnchor);
      double min_range = std::floor(
          0.5 * (double)(r.k + r.lnk - 2 * kMinAnchor));
      double min_value = (double)std::max(
          0, std::min(r.k - kMinAnchor, r.lnk - kMinAnchor));
      pos_sum += pos_value / pos_range;
      min_sum += min_value / min_range;
    }
    char pos_str[64], min_str[64];
    snprintf(pos_str, sizeof pos_str, "%.6g", pos_sum / (double)n_kept);
    snprintf(min_str, sizeof min_str, "%.6g", min_sum / (double)n_kept);
    snprintf(fbuf, sizeof fbuf, "%d\t", fid);
    seq_buf += fbuf;
    seq_buf += sequence;
    snprintf(fbuf, sizeof fbuf, "\t0\t%ld\t%s\t%s\n", n_kept, pos_str,
             min_str);
    seq_buf += fbuf;
    for (int e = 0; e < 2; e++) {
      snprintf(fbuf, sizeof fbuf, "%d\t%d\t", fid, e);
      break_buf += fbuf;
      break_buf.append(refname_concat + refname_off[2 * ti + e],
                       refname_concat + refname_off[2 * ti + e + 1]);
      snprintf(fbuf, sizeof fbuf, "\t%c\t%ld\n",
               align_strand[2 * ti + e] == 0 ? '+' : '-',
               (long)break_pos[e]);
      break_buf += fbuf;
    }
    g = h;
  }

  // all evaluation succeeded: write the five artifacts
  auto write_all = [](const char* path, const std::string& s) {
    FILE* f = fopen(path, "wb");
    if (!f) return false;
    size_t nw = fwrite(s.data(), 1, s.size(), f);
    return fclose(f) == 0 && nw == s.size();
  };
  {
    std::string buf;
    for (const EmittedRow& r : rows) buf += r.line;
    if (!write_all(out_path, buf)) return -1;
    buf.clear();
    for (int32_t i : order) buf += rows[i].line;
    if (!write_all(sorted_path, buf)) return -1;
  }
  if (!write_all(seq_path, seq_buf)) return -1;
  if (!write_all(break_path, break_buf)) return -1;
  if (!write_all(pred_path, pred_buf)) return -1;
  return total;
}

void dt_driver_free(void* handle) { delete (RealignDriver*)handle; }

}  // extern "C"

// ---------------------------------------------------------------------
// Seed-table build for the seed-and-extend aligner: packed (key<<32|pos)
// values for every valid intra-sequence k-mer window, sorted — identical
// ordering to the numpy stable-argsort build in align/seedindex.py
// (key ascending, position ascending within key; k <= 16 so the 2-bit
// key fits 32 bits and one uint64 sort gives both orders).
// ---------------------------------------------------------------------

namespace {

void MergeSortU64(std::vector<uint64_t>& v, int n_threads) {
  // chunked parallel std::sort + buffered pairwise std::merge passes
  size_t n = v.size();
  if (n_threads < 2 || n < (1u << 16)) {
    std::sort(v.begin(), v.end());
    return;
  }
  int chunks = n_threads;
  std::vector<size_t> bounds(chunks + 1);
  for (int c = 0; c <= chunks; c++) bounds[c] = n * c / chunks;
  {
    std::vector<std::thread> ts;
    for (int c = 0; c < chunks; c++)
      ts.emplace_back([&, c]() {
        std::sort(v.begin() + bounds[c], v.begin() + bounds[c + 1]);
      });
    for (auto& t : ts) t.join();
  }
  std::vector<uint64_t> tmp(n);
  uint64_t* cur = v.data();
  uint64_t* other = tmp.data();
  while (chunks > 1) {
    std::vector<std::thread> ts;
    std::vector<size_t> nb;
    for (int c = 0; c < chunks; c += 2) {
      if (c + 1 < chunks) {
        ts.emplace_back([&, c, cur, other]() {
          std::merge(cur + bounds[c], cur + bounds[c + 1],
                     cur + bounds[c + 1], cur + bounds[c + 2],
                     other + bounds[c]);
        });
      } else {
        ts.emplace_back([&, c, cur, other]() {
          std::copy(cur + bounds[c], cur + bounds[c + 1],
                    other + bounds[c]);
        });
      }
      nb.push_back(bounds[c]);
    }
    for (auto& t : ts) t.join();
    nb.push_back(n);
    bounds = nb;
    chunks = (int)bounds.size() - 1;
    std::swap(cur, other);
  }
  if (cur != v.data()) std::copy(cur, cur + n, v.data());
}

}  // namespace

extern "C" {

// codes: int8 (0..3 = ACGT, 4 = other), offsets: per-sequence bounds.
// out: capacity n (upper bound on window count).  Returns the number of
// valid windows written, sorted.
long dt_build_seed_index(const int8_t* codes, long n,
                         const int64_t* offsets, int n_seqs, int k,
                         int n_threads, uint64_t* out) {
  if (k < 1 || k > 16) return -1;
  // positions are packed into the low 32 bits of (key<<32)|pos: a
  // concatenated reference >= 2^32 bp would silently corrupt both halves.
  if (n >= (1L << 32)) return -1;
  if (n_threads < 1) n_threads = 1;
  std::vector<std::vector<uint64_t>> parts(n_seqs);
  {
    std::vector<std::thread> ts;
    std::atomic<int> next{0};
    for (int t = 0; t < n_threads; t++)
      ts.emplace_back([&]() {
        for (;;) {
          int s = next.fetch_add(1);
          if (s >= n_seqs) return;
          int64_t lo = offsets[s], hi = offsets[s + 1];
          if (hi - lo < k) continue;
          auto& part = parts[s];
          part.reserve(hi - lo - k + 1);
          uint64_t key = 0;
          int run = 0;  // consecutive ACGT codes ending here
          const uint64_t mask =
              (k == 16) ? ~0ull >> 32 : ((1ull << (2 * k)) - 1);
          for (int64_t i = lo; i < hi; i++) {
            int8_t c = codes[i];
            if (c >= 4) {
              run = 0;
              key = 0;
              continue;
            }
            key = ((key << 2) | (uint64_t)c) & mask;
            if (++run >= k)
              part.push_back((key << 32) | (uint64_t)(i - k + 1));
          }
        }
      });
    for (auto& t : ts) t.join();
  }
  std::vector<uint64_t> all;
  size_t total = 0;
  for (auto& p : parts) total += p.size();
  all.reserve(total);
  for (auto& p : parts) {
    all.insert(all.end(), p.begin(), p.end());
    p.clear();
    p.shrink_to_fit();
  }
  MergeSortU64(all, n_threads);
  std::copy(all.begin(), all.end(), out);
  return (long)all.size();
}

}  // extern "C"

// ---------------------------------------------------------------------
// Seed-and-extend read alignment: 3-seed pigeonhole candidates from the
// sorted seed table + end-to-end mismatch verification, both strands.
// Exact contract of align/seedindex.SeedIndex.align_batch (candidate
// cap per seed, sorted-unique candidate order, bounds checks); the
// bowtie -m sentinel is applied by the Python caller.
// ---------------------------------------------------------------------

extern "C" {

// out rows: (read_idx, seq_i, pos0, strand, mismatches) int32 x5,
// grouped by read ascending, per read: fwd hits (pos ascending) then
// rev hits.  Returns total rows (caller retries if > cap).
long dt_align_batch(const int8_t* codes, long n_codes,
                    const int64_t* seq_offsets, int n_seqs,
                    const uint64_t* keys, const int64_t* positions,
                    long n_keys, int k, const int32_t* seed_offs,
                    int n_seed_offs, const uint8_t* reads,
                    const int32_t* read_lens, long n_reads, int width,
                    int max_per_seed, int max_mismatch, int n_threads,
                    int32_t* out, long cap) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::vector<int32_t>> results(n_reads);
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; t++) {
    ts.emplace_back([&, t]() {
      std::vector<int8_t> q[2];
      std::vector<int64_t> cands;
      static const int8_t comp[5] = {3, 2, 1, 0, 4};
      for (long r = t; r < n_reads; r += n_threads) {
        int len = read_lens[r];
        const uint8_t* row = reads + (size_t)r * width;
        q[0].assign(row, row + len);
        q[1].resize(len);
        for (int i = 0; i < len; i++)
          q[1][i] = comp[(int)row[len - 1 - i]];
        auto& res = results[r];
        for (int strand = 0; strand < 2; strand++) {
          const int8_t* rc = q[strand].data();
          cands.clear();
          for (int si = 0; si < n_seed_offs; si++) {
            int off = seed_offs[si];
            if (off + k > len) continue;  // padded window = invalid
            uint64_t key = 0;
            bool valid = true;
            for (int j = 0; j < k; j++) {
              int8_t c = rc[off + j];
              if (c >= 4) {
                valid = false;
                break;
              }
              key = (key << 2) | (uint64_t)c;
            }
            if (!valid) continue;
            const uint64_t* lo =
                std::lower_bound(keys, keys + n_keys, key);
            const uint64_t* hi = std::upper_bound(lo, keys + n_keys, key);
            long count = std::min<long>(hi - lo, max_per_seed);
            long base = lo - keys;
            for (long c = 0; c < count; c++)
              cands.push_back(positions[base + c] - off);
          }
          std::sort(cands.begin(), cands.end());
          cands.erase(std::unique(cands.begin(), cands.end()),
                      cands.end());
          for (int64_t cand : cands) {
            if (cand < 0) continue;
            // containing sequence + bounds
            const int64_t* s = std::upper_bound(
                seq_offsets, seq_offsets + n_seqs + 1, cand) - 1;
            int seq_i = (int)(s - seq_offsets);
            if (seq_i < 0 || seq_i >= n_seqs) continue;
            if (cand + len > seq_offsets[seq_i + 1]) continue;
            int mm = 0;
            const int8_t* win = codes + cand;
            for (int j = 0; j < len; j++) mm += (win[j] != rc[j]);
            if (mm > max_mismatch) continue;
            res.push_back((int32_t)r);
            res.push_back(seq_i);
            res.push_back((int32_t)(cand - seq_offsets[seq_i]));
            res.push_back(strand);
            res.push_back(mm);
          }
        }
      }
    });
  }
  for (auto& th : ts) th.join();
  long total = 0;
  for (const auto& res : results) total += (long)(res.size() / 5);
  if (total <= cap) {
    int32_t* p = out;
    for (const auto& res : results) {
      std::copy(res.begin(), res.end(), p);
      p += res.size();
    }
  }
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Native alignment frontend: the full alignjob flow in C++
// (align/frontend.py::align_job contract; reference scripts/alignjob.pl
// 216-331).  Phase 1: untrimmed paired concordant screens vs cdna and
// genome.  Phase 2 (candidates = non-concordant fragments): trimmed
// single-end all-alignments (-k/-m), unmappable / same-gene /
// same-region re-screens, rRNA screen, unigene prefilter paired screen
// (alignjob.pl:289-305), IG-pair exclusion, and emission of
// improper.sam + spanning.compact + cdna.pair.sam byte-identical to the
// Python frontend.
// ---------------------------------------------------------------------

namespace alignjob {

struct SeedIdx {
  const int8_t* codes = nullptr;
  int64_t n_codes = 0;
  const int64_t* seq_off = nullptr;
  int n_seqs = 0;
  const uint64_t* keys = nullptr;
  const int64_t* pos = nullptr;
  int64_t n_keys = 0;
  int k = 16;
  // optional bucket prefix table over the top bits of the 2k-bit key:
  // bucket b spans keys[boff[b]..boff[b+1]).  Narrows every seed
  // lookup from a log2(n_keys)-probe binary search (each probe a
  // likely cache miss on genome-scale indexes) to ~1 probe in a
  // handful of entries.  null = fall back to the full-range search.
  const int64_t* boff = nullptr;
  int bshift = 0;
  bool present() const { return codes != nullptr; }
};

// Build the prefix table for ix (P = min(2k, 22) bucket bits; 22 keeps
// the table at 32MB worst case).  Keys are sorted, so the counting
// pass touches buckets in ascending order.
inline void BuildPrefixTable(SeedIdx& ix, std::vector<int64_t>& storage) {
  if (!ix.present() || ix.n_keys == 0) return;
  int key_bits = 2 * ix.k;
  int p = std::min(key_bits, 22);
  int shift = key_bits - p;
  size_t nb = (size_t)1 << p;
  storage.assign(nb + 1, 0);
  for (int64_t i = 0; i < ix.n_keys; i++)
    storage[(size_t)(ix.keys[i] >> shift) + 1]++;
  for (size_t b = 1; b <= nb; b++) storage[b] += storage[b - 1];
  ix.boff = storage.data();
  ix.bshift = shift;
}

// Process-wide prefix-table cache: one mmap-loaded index serves every
// shard of a run, so the counting pass (~0.1s per shard at genome
// scale) is paid once.  Keyed by (keys pointer, n_keys, k) and
// validated by the first/last key values, so a freed-and-remapped
// index at the same address cannot serve a stale table.  Entries can
// also be seeded from a PERSISTED table (dt_prefixtab_attach: written
// at create-ref, mmap-loaded by the run), skipping the counting pass
// entirely.
inline std::mutex& PtabMutex() {
  static std::mutex mu;
  return mu;
}
using PtabCache =
    std::map<std::tuple<const uint64_t*, int64_t, int>,
             std::pair<std::pair<uint64_t, uint64_t>,
                       std::shared_ptr<std::vector<int64_t>>>>;
inline PtabCache& PtabEntries() {
  static PtabCache cache;
  return cache;
}

inline void BuildPrefixTableCached(
    SeedIdx& ix, std::shared_ptr<std::vector<int64_t>>& keep) {
  if (!ix.present() || ix.n_keys == 0) return;
  int key_bits = 2 * ix.k;
  int shift = key_bits - std::min(key_bits, 22);
  auto ckey = std::make_tuple(ix.keys, ix.n_keys, ix.k);
  auto sig = std::make_pair(ix.keys[0], ix.keys[ix.n_keys - 1]);
  {
    std::lock_guard<std::mutex> lk(PtabMutex());
    auto it = PtabEntries().find(ckey);
    if (it != PtabEntries().end() && it->second.first == sig) {
      keep = it->second.second;
      ix.boff = keep->data();
      ix.bshift = shift;
      return;
    }
  }
  auto fresh = std::make_shared<std::vector<int64_t>>();
  BuildPrefixTable(ix, *fresh);
  keep = fresh;
  ix.boff = keep->data();
  ix.bshift = shift;
  std::lock_guard<std::mutex> lk(PtabMutex());
  PtabEntries()[ckey] = {sig, fresh};
}

// Binary proper-pair table (cdna.pair.tbl): the pair.sam content in a
// directly scannable layout so downstream checkpointed stages (read
// stats, calccov) don't re-parse hundreds of MB of SAM text.  Layout:
// 8B magic "DPTBL1\n", i64 n_pairs, i64 n_names, i64 blob_len,
// (n_names+1) i64 name offsets, name blob, then n_pairs records.
struct PairRec {
  int64_t frag;
  int32_t seq;           // cdna reference id (index into name table)
  int32_t pos1, len1;    // end-1 alignment: 1-based start, read length
  int32_t pos2, len2;    // end-2 alignment
  int32_t isize;         // insert size (positive)
};
static_assert(sizeof(PairRec) == 32, "packed pair record");
// v2 packs the end-1 strand into the seq high bit; v1 predates the bit
// (readers accept both, but only v2 tables can regenerate SAM flags /
// strand-dependent indices — consumers check PairTbl.has_strand)
constexpr char kPairTblMagic[8] = {'D', 'P', 'T', 'B', 'L', '2', '\n', 0};
constexpr char kPairTblMagicV1[8] = {'D', 'P', 'T', 'B', 'L', '1', '\n',
                                     0};

struct PairTbl {
  std::vector<int64_t> name_off;
  std::string blob;
  std::vector<PairRec> recs;
  // end-1 strand (0 fwd / 1 rev), unpacked from the seq high bit by
  // LoadPairTbl; recs[i].seq is left masked to the bare name index.
  // Needed to regenerate the pair SAM's flag bits exactly (the proper
  // pair rule fwd.start <= rev.start leaves pos1 == pos2 ambiguous).
  std::vector<uint8_t> strand1;
  bool has_strand = true;  // false when any segment is v1 (pre-bit)
};

// A table file is one or more concatenated self-describing segments
// (sequential append-mode shard writes, align_job ``append``); every
// segment must carry the identical name table.
inline bool LoadPairTbl(const char* path, PairTbl& t) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = true;
  bool first = true;
  for (;;) {
    char magic[8];
    size_t got = fread(magic, 1, 8, f);
    if (got == 0 && !first) break;  // clean EOF between segments
    int64_t n_pairs = 0, n_names = 0, blob_len = 0;
    bool v1 = got == 8 && memcmp(magic, kPairTblMagicV1, 8) == 0;
    if (v1) t.has_strand = false;
    ok = got == 8 &&
         (v1 || memcmp(magic, kPairTblMagic, 8) == 0) &&
         fread(&n_pairs, 8, 1, f) == 1 &&
         fread(&n_names, 8, 1, f) == 1 &&
         fread(&blob_len, 8, 1, f) == 1 && n_pairs >= 0 &&
         n_names >= 0 && blob_len >= 0;
    if (!ok) break;
    std::vector<int64_t> name_off(n_names + 1);
    std::string blob(blob_len, '\0');
    ok = fread(name_off.data(), 8, n_names + 1, f) ==
             (size_t)(n_names + 1) &&
         (blob_len == 0 ||
          fread(&blob[0], 1, blob_len, f) == (size_t)blob_len);
    if (!ok) break;
    if (first) {
      t.name_off.swap(name_off);
      t.blob.swap(blob);
    } else if (name_off != t.name_off || blob != t.blob) {
      ok = false;  // segments must share one name table
      break;
    }
    size_t base = t.recs.size();
    t.recs.resize(base + n_pairs);
    ok = n_pairs == 0 || fread(t.recs.data() + base, sizeof(PairRec),
                               n_pairs, f) == (size_t)n_pairs;
    if (!ok) break;
    first = false;
  }
  fclose(f);
  if (ok) {
    // one threaded strand-unpack/mask pass over all segments (the
    // 9.5M-record loop is measurable at the 10M-pair scale)
    size_t n = t.recs.size();
    t.strand1.resize(n);
    int nt = (int)std::min<size_t>(4, std::max<size_t>(1, n / 500000));
    std::vector<std::thread> ts;
    for (int w = 0; w < nt; w++)
      ts.emplace_back([&t, n, nt, w]() {
        size_t lo = n * w / nt, hi = n * (w + 1) / nt;
        for (size_t i = lo; i < hi; i++) {
          t.strand1[i] = (uint8_t)(((uint32_t)t.recs[i].seq) >> 31);
          t.recs[i].seq =
              (int32_t)(((uint32_t)t.recs[i].seq) & 0x7fffffffu);
        }
      });
    for (auto& th : ts) th.join();
  }
  return ok;
}

// Process-wide single-slot pair-table cache: the read-stats and calccov
// stages scan the same multi-GB table back to back; loading it once
// per pipeline process saves a full parse + RAM churn.  Staleness is
// checked by (path, size, mtime incl. nanoseconds); dt_pairtbl_cache_clear
// releases the memory once the consumers are done.
struct TblCacheEntry {
  std::string path;
  off_t size = -1;
  long mtime_s = 0, mtime_ns = 0;
  std::shared_ptr<PairTbl> tbl;
};
inline std::mutex& TblCacheMu() {
  static std::mutex mu;
  return mu;
}
inline TblCacheEntry& TblCache() {
  static TblCacheEntry e;
  return e;
}
inline std::shared_ptr<PairTbl> GetPairTblCached(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return nullptr;
  std::lock_guard<std::mutex> lk(TblCacheMu());
  TblCacheEntry& e = TblCache();
  if (e.tbl && e.path == path && e.size == st.st_size &&
      e.mtime_s == (long)st.st_mtim.tv_sec &&
      e.mtime_ns == (long)st.st_mtim.tv_nsec)
    return e.tbl;
  auto t = std::make_shared<PairTbl>();
  if (!LoadPairTbl(path, *t)) return nullptr;
  e = {path, st.st_size, (long)st.st_mtim.tv_sec,
       (long)st.st_mtim.tv_nsec, t};
  return t;
}

// per-reference remap metadata (cdna: transcripts; genome: chromosomes)
struct RefMeta {
  const int32_t* gene = nullptr;   // interned gene, -1 none
  const int32_t* chrom = nullptr;  // interned chromosome
  const int8_t* strand = nullptr;  // 0 '+', 1 '-'
  const int32_t* txlen = nullptr;
  const int64_t* exon_off = nullptr;  // n_refs+1; equal bounds = not tx
  const int64_t* exon_gs = nullptr;   // ascending genomic exon starts
  const int64_t* exon_ge = nullptr;
  const uint8_t* known = nullptr;  // is_transcript || is_chromosome
  const uint8_t* is_ig = nullptr;  // cdna ref gene in ig_gene_list
};

struct Hit {
  int32_t seq;
  int32_t pos0;  // 0-based start within sequence
  int8_t strand;
  int8_t mm;
};

constexpr int64_t kUnmappableBin = 200000;  // frontend.py UNMAPPABLE_BIN
constexpr int64_t kGeneBinSpacing = 10000;  // gene_models.py BIN_SPACING
// (floor division: the file-level FloorDiv above is reused)

// seed_offsets(L, k) mirror (align/seedindex.py): disjoint for L>=3k,
// staggered [0,(L-k)/2,L-k] (sorted unique) otherwise
inline void SeedOffsets(int L, int k, std::vector<int32_t>& out) {
  out.clear();
  if (L >= 3 * k) {
    out = {0, k, 2 * k};
  } else if (L >= k) {
    int32_t a = 0, b = (L - k) / 2, c = L - k;
    out.push_back(a);
    if (b != a) out.push_back(b);
    if (c != b && c != a) out.push_back(c);
    std::sort(out.begin(), out.end());
  }
}

// one read against one index, both strands; identical hit order to
// dt_align_batch (strand 0 then 1; per strand: candidate positions
// sorted unique ascending).  stop_early: return on first accepted hit.
// cap<0: unlimited.  Returns false when hit count exceeded cap.
inline bool AlignRead(const SeedIdx& ix, const int8_t* fwd,
                      const int8_t* rev, int len,
                      const std::vector<int32_t>& seed_offs,
                      int max_per_seed, int max_mismatch, long cap,
                      std::vector<Hit>& out, bool stop_early = false,
                      std::vector<int64_t>* scratch = nullptr) {
  out.clear();
  if (len < ix.k || ix.n_keys == 0) return true;
  std::vector<int64_t> local;
  std::vector<int64_t>& cands = scratch ? *scratch : local;
  const int k = ix.k;
  for (int strand = 0; strand < 2; strand++) {
    const int8_t* rc = strand ? rev : fwd;
    cands.clear();
    for (int32_t off : seed_offs) {
      if (off + k > len) continue;
      uint64_t key = 0;
      bool valid = true;
      for (int j = 0; j < k; j++) {
        int8_t c = rc[off + j];
        if (c >= 4) {
          valid = false;
          break;
        }
        key = (key << 2) | (uint64_t)c;
      }
      if (!valid) continue;
      const uint64_t* range_lo = ix.keys;
      const uint64_t* range_hi = ix.keys + ix.n_keys;
      if (ix.boff) {
        size_t b = (size_t)(key >> ix.bshift);
        range_lo = ix.keys + ix.boff[b];
        range_hi = ix.keys + ix.boff[b + 1];
      }
      const uint64_t* lo = std::lower_bound(range_lo, range_hi, key);
      const uint64_t* hi = std::upper_bound(lo, range_hi, key);
      long count = std::min<long>(hi - lo, max_per_seed);
      long base = lo - ix.keys;
      for (long c = 0; c < count; c++)
        cands.push_back(ix.pos[base + c] - off);
    }
    std::sort(cands.begin(), cands.end());
    cands.erase(std::unique(cands.begin(), cands.end()), cands.end());
    for (int64_t cand : cands) {
      if (cand < 0) continue;
      const int64_t* s = std::upper_bound(ix.seq_off,
                                          ix.seq_off + ix.n_seqs + 1,
                                          cand) - 1;
      int seq_i = (int)(s - ix.seq_off);
      if (seq_i < 0 || seq_i >= ix.n_seqs) continue;
      if (cand + len > ix.seq_off[seq_i + 1]) continue;
      int mm = 0;
      const int8_t* win = ix.codes + cand;
      for (int j = 0; j < len; j++) mm += (win[j] != rc[j]);
      if (mm > max_mismatch) continue;
      out.push_back({seq_i, (int32_t)(cand - ix.seq_off[seq_i]),
                     (int8_t)strand, (int8_t)mm});
      if (stop_early) return true;
      if (cap >= 0 && (long)out.size() > cap) return false;
    }
  }
  return true;
}

// gene_models.calc_genomic_position (gene_models.pm:372-412)
inline int64_t GenomicPos(const RefMeta& m, int ref, int64_t position) {
  int64_t e0 = m.exon_off ? m.exon_off[ref] : 0;
  int64_t e1 = m.exon_off ? m.exon_off[ref + 1] : 0;
  if (e0 == e1) return position;
  if (m.strand[ref]) position = (int64_t)m.txlen[ref] - position + 1;
  if (position < 1) return m.exon_gs[e0] + position - 1;
  int64_t local = 0;
  for (int64_t e = e0; e < e1; e++) {
    int64_t size = m.exon_ge[e] - m.exon_gs[e] + 1;
    if (position <= local + size) return position - local - 1 + m.exon_gs[e];
    local += size;
  }
  return position - local + m.exon_ge[e1 - 1];
}

// gene_models.calc_genomic_regions (gene_models.pm:415-469)
inline void GenomicRegions(const RefMeta& m, int ref, int64_t lo,
                           int64_t hi,
                           std::vector<std::pair<int64_t, int64_t>>& out) {
  out.clear();
  int64_t e0 = m.exon_off ? m.exon_off[ref] : 0;
  int64_t e1 = m.exon_off ? m.exon_off[ref + 1] : 0;
  if (e0 == e1) {
    out.emplace_back(lo, hi);
    return;
  }
  int64_t length = m.txlen[ref];
  if (m.strand[ref]) {
    int64_t nlo = length - hi + 1, nhi = length - lo + 1;
    lo = nlo;
    hi = nhi;
  }
  if (lo < 1) lo = 1;
  if (hi > length) hi = length;
  int64_t local = 0;
  for (int64_t e = e0; e < e1; e++) {
    int64_t es = m.exon_gs[e], ee = m.exon_ge[e];
    int64_t size = ee - es + 1;
    int64_t local_start = lo - local;
    int64_t local_end = hi - local;
    int64_t ov_start = std::max<int64_t>(1, local_start) + es - 1;
    int64_t ov_end = std::min<int64_t>(size, local_end) + es - 1;
    if (ov_start <= ov_end) out.emplace_back(ov_start, ov_end);
    local += size;
  }
}

// binned gene interval index: sorted (chrom<<32|bin) keys
struct GeneBins {
  const int64_t* keys = nullptr;
  const int64_t* off = nullptr;
  const int32_t* genes = nullptr;
  int64_t n = 0;
  const int64_t* gene_rs = nullptr;
  const int64_t* gene_re = nullptr;
};

// gene_models.calc_overlapping_genes: collect interned gene ids whose
// region overlaps any genomic region of (ref, lo..hi)
inline void OverlappingGenes(const RefMeta& m, const GeneBins& gb, int ref,
                             int64_t lo, int64_t hi,
                             std::vector<std::pair<int64_t, int64_t>>& rbuf,
                             std::vector<int32_t>& out) {
  if (!m.known || !m.known[ref]) return;
  int32_t chrom = m.chrom[ref];
  GenomicRegions(m, ref, lo, hi, rbuf);
  for (auto& gr : rbuf) {
    int64_t b0 = FloorDiv(gr.first, kGeneBinSpacing);
    int64_t b1 = FloorDiv(gr.second, kGeneBinSpacing);
    for (int64_t b = b0; b <= b1; b++) {
      int64_t key = ((int64_t)chrom << 32) | (b & 0xFFFFFFFFLL);
      const int64_t* it = std::lower_bound(gb.keys, gb.keys + gb.n, key);
      if (it == gb.keys + gb.n || *it != key) continue;
      int64_t bi = it - gb.keys;
      for (int64_t gi = gb.off[bi]; gi < gb.off[bi + 1]; gi++) {
        int32_t g = gb.genes[gi];
        if (!(gr.second < gb.gene_rs[g] || gr.first > gb.gene_re[g]))
          out.push_back(g);
      }
    }
  }
}

// frontend._genomic_loci_count: overlap-group count over the remapped
// alignments (ascending-index greedy removal; overlap via shared
// 200kb-bin membership == plain interval overlap)
inline int LociCount(const std::vector<std::array<int64_t, 3>>& positions) {
  int n = (int)positions.size();
  if (n == 0) return 0;
  std::vector<char> removed(n, 0);
  int count = 0;
  for (int i = 0; i < n; i++) {
    if (removed[i]) continue;
    count++;
    for (int j = 0; j < n; j++) {
      if (positions[i][0] != positions[j][0]) continue;  // chrom
      if (positions[i][2] < positions[j][1] ||
          positions[i][1] > positions[j][2])
        continue;
      removed[j] = 1;
    }
  }
  return count;
}

struct PairBest {
  bool found = false;
  Hit a1, a2;
  int64_t isize = 0;
};

// frontend._best_proper_pairs inner: best (mm sum, fwd start) strict-<
// over al1 x al2 in iteration order, same ref, opposite strand,
// fwd.start <= rev.start, insert within bound
inline PairBest BestProperPair(const std::vector<Hit>& al1,
                               const std::vector<Hit>& al2, int len1,
                               int len2, int64_t max_insert) {
  PairBest best;
  int64_t bk0 = 0, bk1 = 0;
  for (const Hit& a1 : al1) {
    for (const Hit& a2 : al2) {
      if (a1.seq != a2.seq || a1.strand == a2.strand) continue;
      int64_t fwd_start, rev_end;
      if (a1.strand == 0) {
        fwd_start = a1.pos0 + 1;
        rev_end = a2.pos0 + len2;
        if (fwd_start > a2.pos0 + 1) continue;
      } else {
        fwd_start = a2.pos0 + 1;
        rev_end = a1.pos0 + len1;
        if (fwd_start > a1.pos0 + 1) continue;
      }
      int64_t isize = rev_end - fwd_start + 1;
      if (isize > max_insert) continue;
      int64_t k0 = a1.mm + a2.mm, k1 = fwd_start;
      if (!best.found || k0 < bk0 || (k0 == bk0 && k1 < bk1)) {
        best.found = true;
        best.a1 = a1;
        best.a2 = a2;
        best.isize = isize;
        bk0 = k0;
        bk1 = k1;
      }
    }
  }
  return best;
}

}  // namespace alignjob

extern "C" {

// Seed the process prefix-table cache from a persisted table
// (<index>.ptab.npy, written at create-ref; content identical to
// BuildPrefixTable's counting pass).  The table is COPIED into a
// native-owned buffer: the cache outlives any one Python mmap, and a
// same-address remap of the same file must never leave a dangling
// pointer.  Returns 0 on accept, nonzero when the shape disagrees
// with (n_keys, k) — caller falls back to the in-process build.
int dt_prefixtab_attach(const uint64_t* keys, int64_t n_keys, int k,
                        const int64_t* ptab, int64_t ptab_len) {
  using namespace alignjob;
  if (!keys || n_keys <= 0 || !ptab) return 1;
  int key_bits = 2 * k;
  int p = std::min(key_bits, 22);
  if (ptab_len != ((int64_t)1 << p) + 1) return 2;
  if (ptab[0] != 0 || ptab[ptab_len - 1] != n_keys) return 3;
  // full consistency check: EVERY bucket boundary key must straddle
  // its bucket (a corrupted interior entry silently mis-buckets seed
  // lookups and drops hits).  One linear pass over the 2^p+1 entries —
  // a few ms, negligible next to the ~1.8s counting pass being
  // skipped.  (A 64-sample spot check was not enough: mixed-generation
  // files whose end keys happen to match would pass it.)
  int shift = key_bits - p;
  int64_t nb = ptab_len - 1;
  for (int64_t b = 1; b < nb; b++) {
    int64_t off = ptab[b];
    if (off < ptab[b - 1] || off > n_keys) return 4;
    if (off < n_keys && (int64_t)(keys[off] >> shift) < b) return 4;
    if (off > 0 && (int64_t)(keys[off - 1] >> shift) >= b) return 4;
  }
  if (ptab[nb] < ptab[nb - 1]) return 4;
  auto ckey = std::make_tuple(keys, n_keys, k);
  auto sig = std::make_pair(keys[0], keys[n_keys - 1]);
  auto copy = std::make_shared<std::vector<int64_t>>(ptab,
                                                     ptab + ptab_len);
  std::lock_guard<std::mutex> lk(PtabMutex());
  PtabEntries()[ckey] = {sig, copy};
  return 0;
}

}  // extern "C"

extern "C" {

// Full alignjob flow (align/frontend.py::align_job byte contract).
// Index groups: cdna, genome required; rrna, prefilter optional (null
// codes pointer = absent).  Names are concatenated blobs with offsets.
// Outputs: the three files plus concordant/blacklist bitmaps and
// int64 stats_out[3] = {n_pairs, sum_isize, sumsq_isize}.
long dt_align_job(
    const uint8_t* reads1, const uint8_t* reads2, const int32_t* lens1,
    const int32_t* lens2, long n_frags, int width,
    // cdna index
    const int8_t* c_codes, long c_ncodes, const int64_t* c_soff,
    int c_nseqs, const uint64_t* c_keys, const int64_t* c_posn,
    long c_nkeys, int c_k,
    // genome index
    const int8_t* g_codes, long g_ncodes, const int64_t* g_soff,
    int g_nseqs, const uint64_t* g_keys, const int64_t* g_posn,
    long g_nkeys, int g_k,
    // rrna index (nullable)
    const int8_t* r_codes, long r_ncodes, const int64_t* r_soff,
    int r_nseqs, const uint64_t* r_keys, const int64_t* r_posn,
    long r_nkeys, int r_k,
    // prefilter index (nullable)
    const int8_t* p_codes, long p_ncodes, const int64_t* p_soff,
    int p_nseqs, const uint64_t* p_keys, const int64_t* p_posn,
    long p_nkeys, int p_k,
    // cdna ref meta
    const int32_t* c_gene, const int32_t* c_chrom, const int8_t* c_strand,
    const int32_t* c_txlen, const int64_t* c_eoff, const int64_t* c_egs,
    const int64_t* c_ege, const uint8_t* c_known, const uint8_t* c_is_ig,
    // genome ref meta
    const int32_t* g_chrom, const uint8_t* g_known,
    // gene tables
    const int64_t* gene_rs, const int64_t* gene_re, int n_genes,
    const int64_t* gb_keys, const int64_t* gb_off, const int32_t* gb_genes,
    long n_gb,
    // names
    const char* c_names, const int64_t* c_name_off, const char* g_names,
    const int64_t* g_name_off,
    // params
    int trim_len, long max_insert, long max_paired, long concord_len,
    int max_alignments, int max_mismatch, int max_per_seed, int n_threads,
    long frag_base, int append_mode,
    // outputs
    const char* improper_path, const char* spanning_path,
    const char* pair_sam_path, const char* pair_tbl_path,
    uint8_t* concordant_out, uint8_t* blacklist_out,
    int64_t* stats_out) {
  using namespace alignjob;
  if (n_threads < 1) n_threads = 1;
  SeedIdx cdna{c_codes, c_ncodes, c_soff, c_nseqs, c_keys, c_posn,
               c_nkeys, c_k};
  SeedIdx genome{g_codes, g_ncodes, g_soff, g_nseqs, g_keys, g_posn,
                 g_nkeys, g_k};
  SeedIdx rrna{r_codes, r_ncodes, r_soff, r_nseqs, r_keys, r_posn,
               r_nkeys, r_k};
  SeedIdx prefilter{p_codes, p_ncodes, p_soff, p_nseqs, p_keys, p_posn,
                    p_nkeys, p_k};
  const bool aj_timing = getenv("DEFUSE_ALIGNJOB_TIMING") != nullptr;
  auto aj_now = [] {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  };
  double aj_t0 = aj_now();
  // bucket prefix tables (cached across shards; first build threaded)
  std::shared_ptr<std::vector<int64_t>> c_pt, g_pt, r_pt, p_pt;
  {
    std::thread t1([&] { BuildPrefixTableCached(cdna, c_pt); });
    std::thread t2([&] { BuildPrefixTableCached(genome, g_pt); });
    std::thread t3([&] { BuildPrefixTableCached(rrna, r_pt); });
    BuildPrefixTableCached(prefilter, p_pt);
    t1.join();
    t2.join();
    t3.join();
  }
  if (aj_timing) {
    fprintf(stderr, "[alignjob-timing] prefix tables %.3fs\n",
            aj_now() - aj_t0);
    aj_t0 = aj_now();
  }
  RefMeta cmeta{c_gene, c_chrom, c_strand, c_txlen, c_eoff,
                c_egs,  c_ege,   c_known,  c_is_ig};
  RefMeta gmeta;
  gmeta.chrom = g_chrom;
  gmeta.known = g_known;
  GeneBins gb{gb_keys, gb_off, gb_genes, n_gb, gene_rs, gene_re};
  (void)n_genes;

  static const int8_t comp[5] = {3, 2, 1, 0, 4};
  static const int8_t code_of[256] = {/* zero-init, filled below */};
  // build a local code table (A/C/G/T upper+lower, else 4)
  int8_t codeof[256];
  std::fill(codeof, codeof + 256, (int8_t)4);
  codeof['A'] = codeof['a'] = 0;
  codeof['C'] = codeof['c'] = 1;
  codeof['G'] = codeof['g'] = 2;
  codeof['T'] = codeof['t'] = 3;
  (void)code_of;

  // --- batch-max lengths and seed offsets (phase 1) -------------------
  int lmax1 = 0, lmax2 = 0;
  for (long f = 0; f < n_frags; f++) {
    lmax1 = std::max(lmax1, (int)lens1[f]);
    lmax2 = std::max(lmax2, (int)lens2[f]);
  }
  std::vector<int32_t> offs_full_1, offs_full_2;
  SeedOffsets(lmax1, cdna.k, offs_full_1);
  SeedOffsets(lmax2, cdna.k, offs_full_2);

  struct FragPhase1 {
    PairBest cdna_pair;
    bool concordant = false;
  };
  std::vector<FragPhase1> p1(n_frags);

  auto encode_read = [&](const uint8_t* row, int len, std::vector<int8_t>& f,
                         std::vector<int8_t>& r) {
    f.resize(len);
    r.resize(len);
    for (int i = 0; i < len; i++) f[i] = codeof[row[i]];
    for (int i = 0; i < len; i++) r[i] = comp[(int)f[len - 1 - i]];
  };

  {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++)
      ts.emplace_back([&, t]() {
        std::vector<int8_t> f1, r1, f2, r2;
        std::vector<Hit> ca1, ca2, ga1, ga2;
        std::vector<int64_t> scratch;
        for (long f = t; f < n_frags; f += n_threads) {
          int len1 = lens1[f], len2 = lens2[f];
          encode_read(reads1 + (size_t)f * width, len1, f1, r1);
          encode_read(reads2 + (size_t)f * width, len2, f2, r2);
          AlignRead(cdna, f1.data(), r1.data(), len1, offs_full_1,
                    max_per_seed, max_mismatch, -1, ca1, false, &scratch);
          AlignRead(cdna, f2.data(), r2.data(), len2, offs_full_2,
                    max_per_seed, max_mismatch, -1, ca2, false, &scratch);
          PairBest cp = BestProperPair(ca1, ca2, len1, len2, max_insert);
          p1[f].cdna_pair = cp;
          bool conc = cp.found;
          if (!conc) {
            AlignRead(genome, f1.data(), r1.data(), len1, offs_full_1,
                      max_per_seed, max_mismatch, -1, ga1, false,
                      &scratch);
            AlignRead(genome, f2.data(), r2.data(), len2, offs_full_2,
                      max_per_seed, max_mismatch, -1, ga2, false,
                      &scratch);
            conc = BestProperPair(ga1, ga2, len1, len2, max_insert).found;
          } else {
            // genome pair result irrelevant once cdna-concordant
          }
          p1[f].concordant = conc;
        }
      });
    for (auto& th : ts) th.join();
  }
  if (aj_timing) {
    fprintf(stderr, "[alignjob-timing] phase1 concordance %.3fs\n",
            aj_now() - aj_t0);
    aj_t0 = aj_now();
  }

  // --- cdna.pair.sam + stats -----------------------------------------
  // formatting parallelized over contiguous fragment ranges (the int64
  // stat sums are associative, so per-range accumulation + in-order
  // reduction is exact); ranges are written out in order — decompressed
  // content is byte-identical to a sequential pass.  A ".gz" path makes
  // each range a gzip member, deflated inside its own thread.
  int64_t n_pairs = 0, sum_isize = 0, sumsq_isize = 0;
  const bool want_sam = pair_sam_path && pair_sam_path[0];
  const bool pair_gz = want_sam && EndsWithGz(pair_sam_path);
  {
    FILE* out = nullptr;
    if (want_sam) {
      out = fopen(pair_sam_path, append_mode ? "a" : "w");
      if (!out) return -1;
    }
    int nt = n_threads;
    std::vector<std::string> bufs(nt);
    std::vector<std::vector<PairRec>> recs(nt);
    const bool want_tbl = pair_tbl_path && pair_tbl_path[0];
    std::vector<int64_t> np(nt, 0), si(nt, 0), sq(nt, 0);
    std::atomic<bool> gz_fail{false};
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; t++)
      ts.emplace_back([&, t]() {
        long f_lo = n_frags * t / nt, f_hi = n_frags * (t + 1) / nt;
        std::string& buf = bufs[t];
        char tmp[256];
        for (long f = f_lo; f < f_hi; f++) {
          const PairBest& cp = p1[f].cdna_pair;
          if (!cp.found) continue;
          np[t]++;
          si[t] += cp.isize;
          sq[t] += cp.isize * cp.isize;
          if (want_tbl)
            recs[t].push_back(PairRec{
                f + frag_base,
                // seq high bit carries the end-1 strand (LoadPairTbl /
                // read_pair_table unpack it); name indices stay < 2^31
                (int32_t)((uint32_t)cp.a1.seq |
                          ((uint32_t)(cp.a1.strand ? 1 : 0) << 31)),
                cp.a1.pos0 + 1, lens1[f],
                cp.a2.pos0 + 1, lens2[f], (int32_t)cp.isize});
          if (!want_sam) continue;
          for (int end = 0; end < 2; end++) {
            const Hit& a = end == 0 ? cp.a1 : cp.a2;
            const Hit& mate = end == 0 ? cp.a2 : cp.a1;
            int len = end == 0 ? lens1[f] : lens2[f];
            const uint8_t* seq =
                (end == 0 ? reads1 : reads2) + (size_t)f * width;
            int flag = 0x1 | 0x2 | (end == 0 ? 0x40 : 0x80);
            if (a.strand) flag |= 0x10;
            if (mate.strand) flag |= 0x20;
            long sign = (a.pos0 <= mate.pos0) ? 1 : -1;
            snprintf(tmp, sizeof tmp, "%ld\t%d\t", f + frag_base, flag);
            buf += tmp;
            buf.append(c_names + c_name_off[a.seq],
                       c_name_off[a.seq + 1] - c_name_off[a.seq]);
            snprintf(tmp, sizeof tmp, "\t%d\t255\t%dM\t=\t%d\t%ld\t",
                     a.pos0 + 1, len, mate.pos0 + 1, sign * cp.isize);
            buf += tmp;
            buf.append((const char*)seq, len);
            buf += '\t';
            buf.append(len, 'I');
            buf += '\n';
          }
        }
        if (pair_gz) {
          std::string z;
          if (!GzipMember(buf, z))
            gz_fail.store(true);
          buf.swap(z);
        }
      });
    for (auto& th : ts) th.join();
    if (aj_timing) {
      size_t zb = 0;
      for (auto& b : bufs) zb += b.size();
      fprintf(stderr, "[alignjob-timing]   fmt+gzip %.3fs (%zu MB out)\n",
              aj_now() - aj_t0, zb >> 20);
    }
    if (gz_fail.load()) {
      fclose(out);
      return -1;
    }
    for (int t = 0; t < nt; t++) {
      n_pairs += np[t];
      sum_isize += si[t];
      sumsq_isize += sq[t];
      if (out && !bufs[t].empty())
        fwrite(bufs[t].data(), 1, bufs[t].size(), out);
    }
    if (out) fclose(out);
    if (want_tbl) {
      FILE* tf = fopen(pair_tbl_path, append_mode ? "ab" : "wb");
      if (!tf) return -1;
      int64_t n_names = (int64_t)cdna.n_seqs;
      int64_t blob_len = c_name_off[n_names];
      fwrite(kPairTblMagic, 1, 8, tf);
      fwrite(&n_pairs, 8, 1, tf);
      fwrite(&n_names, 8, 1, tf);
      fwrite(&blob_len, 8, 1, tf);
      fwrite(c_name_off, 8, n_names + 1, tf);
      fwrite(c_names, 1, blob_len, tf);
      for (int t = 0; t < nt; t++)
        if (!recs[t].empty())
          fwrite(recs[t].data(), sizeof(PairRec), recs[t].size(), tf);
      fclose(tf);
    }
  }
  stats_out[0] = n_pairs;
  stats_out[1] = sum_isize;
  stats_out[2] = sumsq_isize;
  if (aj_timing) {
    fprintf(stderr, "[alignjob-timing] pair.sam write %.3fs\n",
            aj_now() - aj_t0);
    aj_t0 = aj_now();
  }

  // --- candidates + phase-2 batch maxima ------------------------------
  std::vector<long> cand;
  cand.reserve(n_frags);
  int tmax1 = 0, tmax2 = 0, umax1 = 0, umax2 = 0;
  for (long f = 0; f < n_frags; f++) {
    concordant_out[f] = p1[f].concordant ? 1 : 0;
    blacklist_out[f] = 0;
    if (p1[f].concordant) continue;
    cand.push_back(f);
    tmax1 = std::max(tmax1, std::min((int)lens1[f], trim_len));
    tmax2 = std::max(tmax2, std::min((int)lens2[f], trim_len));
    umax1 = std::max(umax1, (int)lens1[f]);
    umax2 = std::max(umax2, (int)lens2[f]);
  }
  std::vector<int32_t> offs_trim_1, offs_trim_2, offs_cand_1, offs_cand_2;
  SeedOffsets(tmax1, cdna.k, offs_trim_1);
  SeedOffsets(tmax2, cdna.k, offs_trim_2);
  SeedOffsets(umax1, rrna.present() ? rrna.k : cdna.k, offs_cand_1);
  SeedOffsets(umax2, rrna.present() ? rrna.k : cdna.k, offs_cand_2);
  std::vector<int32_t> offs_pre_1, offs_pre_2;
  SeedOffsets(umax1, prefilter.present() ? prefilter.k : cdna.k,
              offs_pre_1);
  SeedOffsets(umax2, prefilter.present() ? prefilter.k : cdna.k,
              offs_pre_2);

  const int64_t ext = concord_len / 2;
  FILE* improper = fopen(improper_path, append_mode ? "a" : "w");
  FILE* spanning = fopen(spanning_path, append_mode ? "a" : "w");
  if (!improper || !spanning) {
    if (improper) fclose(improper);
    if (spanning) fclose(spanning);
    return -1;
  }

  const long kChunk = 8192;
  std::vector<std::string> frag_improper(kChunk), frag_spanning(kChunk);
  for (long chunk = 0; chunk < (long)cand.size(); chunk += kChunk) {
    long hi = std::min<long>(chunk + kChunk, cand.size());
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++)
      ts.emplace_back([&, t, chunk, hi]() {
        std::vector<int8_t> f1, r1, f2, r2, tf1, tr1, tf2, tr2;
        std::vector<Hit> dna[2], cdna_h[2], hits;
        bool over_cap[2][2];  // [end][0=dna,1=cdna]
        std::vector<int64_t> scratch;
        std::vector<std::pair<int64_t, int64_t>> rbuf;
        std::vector<std::array<int64_t, 3>> positions;
        std::vector<int32_t> genes[2];
        std::vector<int64_t> rbins[2];
        char tmp[256];
        for (long ci = chunk + t; ci < hi; ci += n_threads) {
          long f = cand[ci];
          int len1 = lens1[f], len2 = lens2[f];
          int tl1 = std::min(len1, trim_len), tl2 = std::min(len2, trim_len);
          encode_read(reads1 + (size_t)f * width, len1, f1, r1);
          encode_read(reads2 + (size_t)f * width, len2, f2, r2);
          // trimmed codes: prefix of fwd, suffix-reverse recomputed
          tf1.assign(f1.begin(), f1.begin() + tl1);
          tf2.assign(f2.begin(), f2.begin() + tl2);
          tr1.resize(tl1);
          for (int i = 0; i < tl1; i++) tr1[i] = comp[(int)tf1[tl1 - 1 - i]];
          tr2.resize(tl2);
          for (int i = 0; i < tl2; i++) tr2[i] = comp[(int)tf2[tl2 - 1 - i]];

          over_cap[0][0] = !AlignRead(genome, tf1.data(), tr1.data(), tl1,
                                      offs_trim_1, max_per_seed,
                                      max_mismatch, max_alignments, dna[0],
                                      false, &scratch);
          over_cap[1][0] = !AlignRead(genome, tf2.data(), tr2.data(), tl2,
                                      offs_trim_2, max_per_seed,
                                      max_mismatch, max_alignments, dna[1],
                                      false, &scratch);
          over_cap[0][1] = !AlignRead(cdna, tf1.data(), tr1.data(), tl1,
                                      offs_trim_1, max_per_seed,
                                      max_mismatch, max_alignments,
                                      cdna_h[0], false, &scratch);
          over_cap[1][1] = !AlignRead(cdna, tf2.data(), tr2.data(), tl2,
                                      offs_trim_2, max_per_seed,
                                      max_mismatch, max_alignments,
                                      cdna_h[1], false, &scratch);

          bool black = false;
          long counts[2] = {1, 1};
          bool over_cap_any = false;
          for (int end = 0; end < 2; end++) {
            if (over_cap[end][0]) dna[end].clear();
            if (over_cap[end][1]) cdna_h[end].clear();
            over_cap_any |= over_cap[end][0] | over_cap[end][1];
            int tl = end == 0 ? tl1 : tl2;
            positions.clear();
            genes[end].clear();
            rbins[end].clear();
            for (int src = 0; src < 2; src++) {
              const RefMeta& m = src == 0 ? gmeta : cmeta;
              for (const Hit& a : (src == 0 ? dna[end] : cdna_h[end])) {
                int64_t s0 = a.pos0 + 1, e0 = a.pos0 + tl;
                int64_t gs = GenomicPos(m, a.seq, s0);
                int64_t ge = GenomicPos(m, a.seq, e0);
                if (gs > ge) std::swap(gs, ge);
                positions.push_back({(int64_t)m.chrom[a.seq], gs, ge});
                OverlappingGenes(m, gb, a.seq, s0, e0, rbuf, genes[end]);
                GenomicRegions(m, a.seq, s0 - ext, e0 + ext, rbuf);
                if (!rbuf.empty()) {
                  int64_t sp0 = rbuf.front().first,
                          sp1 = rbuf.back().second;
                  int64_t b0 = FloorDiv(sp0, ext), b1 = FloorDiv(sp1, ext);
                  for (int64_t b = b0; b <= b1; b++)
                    rbins[end].push_back(
                        ((int64_t)m.chrom[a.seq] << 32) ^
                        (b & 0xFFFFFFFFLL));
                }
              }
            }
            if (!positions.empty()) counts[end] = LociCount(positions);
            std::sort(genes[end].begin(), genes[end].end());
            genes[end].erase(
                std::unique(genes[end].begin(), genes[end].end()),
                genes[end].end());
            std::sort(rbins[end].begin(), rbins[end].end());
            rbins[end].erase(
                std::unique(rbins[end].begin(), rbins[end].end()),
                rbins[end].end());
          }
          if (over_cap_any) black = true;
          if (counts[0] * counts[1] > max_paired) black = true;
          if (!black) {
            // sorted-vector intersections
            auto intersects = [](const auto& a, const auto& b) {
              size_t i = 0, j = 0;
              while (i < a.size() && j < b.size()) {
                if (a[i] < b[j])
                  i++;
                else if (b[j] < a[i])
                  j++;
                else
                  return true;
              }
              return false;
            };
            if (intersects(genes[0], genes[1])) black = true;
            if (!black && intersects(rbins[0], rbins[1])) black = true;
          }
          if (!black && rrna.present()) {
            if (AlignRead(rrna, f1.data(), r1.data(), len1, offs_cand_1,
                          max_per_seed, max_mismatch, -1, hits, true,
                          &scratch),
                !hits.empty())
              black = true;
            else if (AlignRead(rrna, f2.data(), r2.data(), len2,
                               offs_cand_2, max_per_seed, max_mismatch, -1,
                               hits, true, &scratch),
                     !hits.empty())
              black = true;
          }
          if (!black && prefilter.present()) {
            std::vector<Hit> pa1, pa2;
            AlignRead(prefilter, f1.data(), r1.data(), len1, offs_pre_1,
                      max_per_seed, max_mismatch, -1, pa1, false,
                      &scratch);
            AlignRead(prefilter, f2.data(), r2.data(), len2, offs_pre_2,
                      max_per_seed, max_mismatch, -1, pa2, false,
                      &scratch);
            if (BestProperPair(pa1, pa2, len1, len2, max_insert).found)
              black = true;
          }
          if (!black && cmeta.is_ig) {
            bool ig0 = false, ig1 = false;
            for (const Hit& a : cdna_h[0])
              if (cmeta.is_ig[a.seq]) {
                ig0 = true;
                break;
              }
            if (ig0)
              for (const Hit& a : cdna_h[1])
                if (cmeta.is_ig[a.seq]) {
                  ig1 = true;
                  break;
                }
            if (ig0 && ig1) black = true;
          }

          std::string& imp = frag_improper[ci - chunk];
          std::string& spn = frag_spanning[ci - chunk];
          imp.clear();
          spn.clear();
          if (black) {
            blacklist_out[f] = 1;
            continue;
          }
          int ends_present = 0;
          for (int end = 0; end < 2; end++)
            if (!dna[end].empty() || !cdna_h[end].empty()) ends_present++;
          for (int end = 0; end < 2; end++) {
            int tl = end == 0 ? tl1 : tl2;
            const uint8_t* seq =
                (end == 0 ? reads1 : reads2) + (size_t)f * width;
            for (int src = 0; src < 2; src++) {
              const char* names = src == 0 ? g_names : c_names;
              const int64_t* noff = src == 0 ? g_name_off : c_name_off;
              for (const Hit& a : (src == 0 ? dna[end] : cdna_h[end])) {
                int flag = a.strand ? 0x10 : 0;
                snprintf(tmp, sizeof tmp, "%ld/%d\t%d\t", f + frag_base,
                         end + 1, flag);
                imp += tmp;
                imp.append(names + noff[a.seq],
                           noff[a.seq + 1] - noff[a.seq]);
                snprintf(tmp, sizeof tmp, "\t%d\t255\t%dM\t*\t0\t0\t",
                         a.pos0 + 1, tl);
                imp += tmp;
                imp.append((const char*)seq, tl);
                imp += '\t';
                imp.append(tl, 'I');
                imp += '\n';
                if (ends_present == 2) {
                  snprintf(tmp, sizeof tmp, "%ld\t%d\t", f + frag_base,
                           end);
                  spn += tmp;
                  spn.append(names + noff[a.seq],
                             noff[a.seq + 1] - noff[a.seq]);
                  snprintf(tmp, sizeof tmp, "\t%c\t%d\t%d\n",
                           a.strand ? '-' : '+', a.pos0 + 1, a.pos0 + tl);
                  spn += tmp;
                }
              }
            }
          }
        }
      });
    for (auto& th : ts) th.join();
    for (long ci = chunk; ci < hi; ci++) {
      const std::string& imp = frag_improper[ci - chunk];
      const std::string& spn = frag_spanning[ci - chunk];
      if (!imp.empty()) fwrite(imp.data(), 1, imp.size(), improper);
      if (!spn.empty()) fwrite(spn.data(), 1, spn.size(), spanning);
    }
  }
  fclose(improper);
  fclose(spanning);
  if (aj_timing)
    fprintf(stderr, "[alignjob-timing] phase2 candidates (%ld) %.3fs\n",
            (long)cand.size(), aj_now() - aj_t0);
  return (long)cand.size();
}

}  // extern "C"

// ---------------------------------------------------------------------
// Native calccov: null-distribution sampling from the concordant pair
// SAM (stats/calccov.py byte contract; tools/calccov.cpp:116-207).
// Marker positions (exact glibc rand stream) are sampled Python-side
// and passed in; this does the hot part — SAM parse, per-pair marker
// containment and sample emission.
// ---------------------------------------------------------------------

extern "C" {

// marker_ref/marker_pos: per-marker transcript index + 1-based position.
// ref name interning: names blob + offsets, index == marker ref index.
// Returns total samples written, -2 on a fragment group != 2 rows,
// -1 on IO error.
long dt_calccov(const char* sam_path, const char* names,
                const int64_t* name_off, int n_refs,
                const int32_t* marker_ref, const int64_t* marker_pos,
                long n_markers, long trim_length, long anchor,
                const char* span_path, const char* pos_path,
                const char* min_path) {
  constexpr int64_t kBin = 10000;  // calccov.py BIN_SPACING
  std::unordered_map<std::string, int32_t> ref_of;
  ref_of.reserve(n_refs * 2);
  for (int i = 0; i < n_refs; i++)
    ref_of.emplace(std::string(names + name_off[i],
                               names + name_off[i + 1]), i);
  // markers binned by (ref, pos/kBin); indices ascend within a bin
  std::unordered_map<int64_t, std::vector<int32_t>> bins;
  bins.reserve(n_markers * 2);
  for (long i = 0; i < n_markers; i++)
    bins[((int64_t)marker_ref[i] << 32) |
         (uint32_t)(marker_pos[i] / kBin)]
        .push_back((int32_t)i);

  GzIn in;
  if (!in.open(sam_path)) return -1;
  FILE* f_span = fopen(span_path, "w");
  FILE* f_pos = fopen(pos_path, "w");
  FILE* f_min = fopen(min_path, "w");
  if (!f_span || !f_pos || !f_min) {
    if (f_span) fclose(f_span);
    if (f_pos) fclose(f_pos);
    if (f_min) fclose(f_min);
    return -1;
  }

  struct Aln {
    int32_t ref;
    int64_t start, end;
    bool known;
  };
  std::string line, cur_frag;
  std::vector<Aln> group;
  std::vector<int32_t> hits;
  long total = 0;
  long rc = 0;

  auto contained = [&](int32_t ref, int64_t lo, int64_t hi) {
    hits.clear();
    for (int64_t b = lo / kBin; b <= hi / kBin; b++) {
      auto it = bins.find(((int64_t)ref << 32) | (uint32_t)b);
      if (it == bins.end()) continue;
      hits.insert(hits.end(), it->second.begin(), it->second.end());
    }
    std::sort(hits.begin(), hits.end());
    hits.erase(std::unique(hits.begin(), hits.end()), hits.end());
  };

  auto flush_group = [&]() -> bool {
    if (group.empty()) return true;
    if (group.size() != 2) {
      rc = -2;
      return false;
    }
    const Aln& a0 = group[0];
    const Aln& a1 = group[1];
    if (!a0.known) {
      group.clear();
      return true;
    }
    int32_t ref = a0.ref;
    int64_t unseq_start =
        std::min(a0.start + trim_length, a1.start + trim_length);
    int64_t unseq_end =
        std::max(a0.end - trim_length, a1.end - trim_length);
    int64_t frag_len =
        std::max(a0.end, a1.end) - std::min(a0.start, a1.start);
    contained(ref, unseq_start, unseq_end);
    for (int32_t i : hits) {
      int64_t pos = marker_pos[i];
      if (unseq_start <= pos && pos <= unseq_end) {
        fprintf(f_span, "%d\t%ld\n", i, frag_len);
        total++;
      }
    }
    for (const Aln& a : group) {
      int64_t a_start = a.start + anchor;
      int64_t a_end = a.end - anchor + 1;
      contained(ref, a_start, a_end);
      for (int32_t i : hits) {
        int64_t pos = marker_pos[i];
        if (a_start <= pos && pos <= a_end) {
          // calccov.py calc_split_pos / calc_split_min (f64 exact)
          double v1 = std::max(0.0, (double)(pos - a.start - anchor));
          double r1 = (double)(a.end - a.start) + 1.0 - 2.0 * anchor;
          fprintf(f_pos, "%d\t%.6g\n", i, v1 / r1);
          int64_t m = std::min(pos - a.start - anchor,
                               a.end + 1 - pos - anchor);
          double v2 = std::max(0.0, (double)m);
          double r2 = std::floor(
              0.5 * ((double)(a.end - a.start) + 1.0 - 2.0 * anchor));
          fprintf(f_min, "%d\t%.6g\n", i, v2 / r2);
          total += 2;
        }
      }
    }
    group.clear();
    return true;
  };

  while (in.getline(line)) {
    if (line.empty() || line[0] == '@') continue;
    // fields: qname flag rname pos mapq cigar rnext pnext tlen seq ...
    const char* p = line.c_str();
    const char* tabs[10];
    int nt = 0;
    for (const char* q = p; *q && nt < 10; q++)
      if (*q == '\t') tabs[nt++] = q;
    if (nt < 10) {
      rc = -1;
      break;
    }
    std::string qname(p, tabs[0] - p);
    size_t slash = qname.rfind('/');
    if (slash != std::string::npos) qname.resize(slash);
    std::string rname(tabs[1] + 1, tabs[2] - tabs[1] - 1);
    if (rname == "*") continue;
    if (qname != cur_frag) {
      if (!flush_group()) break;
      cur_frag = qname;
    }
    Aln a;
    a.start = atol(tabs[2] + 1);
    int64_t seq_len = tabs[9] - tabs[8] - 1;
    a.end = a.start + seq_len - 1;
    auto it = ref_of.find(rname);
    a.known = it != ref_of.end();
    a.ref = a.known ? it->second : -1;
    group.push_back(a);
  }
  if (rc == 0) flush_group();
  fclose(f_span);
  fclose(f_pos);
  fclose(f_min);
  return rc < 0 ? rc : total;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Native fastq ingest: the index_paired_fastq stage
// (align/frontend.py::index_paired_fastq byte contract;
// scripts/index_paired_fastq.pl).  Parses both ends (one thread each),
// writes integer-renamed fastqs + the binary .fqi offset index
// (tools/ReadIndex.cpp layout) + the names map, and keeps the read
// bases resident for a zero-copy handoff into dt_align_job's matrix.
// ---------------------------------------------------------------------

namespace fastq_ingest {

inline double IngestNow() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

inline bool IngestTiming() {
  static int flag = -1;
  if (flag < 0) flag = getenv("DEFUSE_INGEST_TIMING") ? 1 : 0;
  return flag == 1;
}

struct End {
  std::vector<char> bases;     // concatenated read bases
  std::vector<int64_t> off;    // n+1 offsets into bases
  std::vector<int64_t> rec_off;  // per-record byte offset (renamed
                                 // file in rewrite mode, input file in
                                 // index-only backed mode)
  std::vector<std::string> names;  // end-1 only
  bool ok = false;
  bool backed = false;  // index-only: offsets point into the ORIGINAL
                        // file (no renamed copy exists on disk)
};

struct Handle {
  End ends[2];
  // deferred artifact writers (.names / .fqi): joined in
  // dt_fastq_free, so the writes overlap the caller's matrix copies
  std::thread names_t, fqi_t;
};

inline bool CopyRange(const char* src, FILE* out, int64_t n) {
  FILE* in = fopen(src, "rb");
  if (!in) return false;
  std::vector<char> buf(1 << 22);
  int64_t left = n;
  while (left > 0) {
    size_t want = (size_t)std::min<int64_t>(left, (int64_t)buf.size());
    size_t got = fread(buf.data(), 1, want, in);
    if (got == 0 || fwrite(buf.data(), 1, got, out) != got) {
      fclose(in);
      return false;
    }
    left -= (int64_t)got;
  }
  fclose(in);
  return true;
}

// Chunked line scanner (memchr): ~4x the throughput of the previous
// getline loop on this workload.  Returned (p, n) views are valid only
// until the next call — callers copy what they keep.
struct LineReader {
  FILE* f;
  std::vector<char> buf;
  size_t lo = 0, hi = 0;
  int64_t base = 0;  // input-file offset of buf[0]
  bool eof = false;
  explicit LineReader(FILE* fh) : f(fh), buf(1 << 22) {}
  bool next(const char*& p, size_t& n) {
    for (;;) {
      char* nl = (char*)memchr(buf.data() + lo, '\n', hi - lo);
      if (nl) {
        p = buf.data() + lo;
        n = (size_t)(nl - (buf.data() + lo));
        lo = (size_t)(nl - buf.data()) + 1;
        return true;
      }
      if (eof) {
        if (hi > lo) {  // final line without a trailing newline
          p = buf.data() + lo;
          n = hi - lo;
          lo = hi;
          return true;
        }
        return false;
      }
      size_t keep = hi - lo;
      base += (int64_t)lo;
      memmove(buf.data(), buf.data() + lo, keep);
      lo = 0;
      hi = keep;
      if (hi == buf.size()) buf.resize(buf.size() * 2);
      size_t got = fread(buf.data() + hi, 1, buf.size() - hi, f);
      hi += got;
      if (got == 0) eof = true;
    }
  }
  // input-file byte offset of a view returned by the LAST next() call
  // (valid until the following next(), like the view itself)
  int64_t off_of(const char* p) const {
    return base + (int64_t)(p - buf.data());
  }
};

// Rewrite is lazy: while every record is already in canonical renamed
// form ("@<i>/<end>\n<seq>\n+\n<'I' x len>\n") nothing is written; the
// first divergent record copies the byte-identical prefix verbatim and
// switches to rewrite mode.  A fully-canonical input (a re-run over our
// own renamed files, or pre-normalized data) is hardlinked into place —
// the ~GB rewrite disappears on the ~70MB/s filesystem.
// exact "%ld" for non-negative values (the per-record snprintf pair
// cost ~40% of the parse loop)
inline char* PutDecimal(char* p, unsigned long u) {
  char b[20];
  char* q = b + 20;
  do {
    *--q = (char)('0' + (u % 10));
    u /= 10;
  } while (u);
  while (q < b + 20) *p++ = *q++;
  return p;
}

// canonical header "@<i>/<end>" writer + length, exact snprintf twin
inline int CanonHeader(char* dst, long i, int end1) {
  char* p = dst;
  *p++ = '@';
  p = PutDecimal(p, (unsigned long)i);
  *p++ = '/';
  *p++ = (char)('0' + end1);
  return (int)(p - dst);
}

inline void ParseAndWrite(const char* in_path, const char* out_path,
                          int end, End& e, bool index_only = false) {
  double t0 = IngestTiming() ? IngestNow() : 0.0;
  FILE* in_f = fopen(in_path, "rb");
  if (!in_f) return;
  {
    // pre-size the retained arrays from the input size (~half the
    // bytes are read bases; reallocation copies of a ~GB vector cost
    // real time at the 10M-pair scale)
    struct stat st;
    if (stat(in_path, &st) == 0 && st.st_size > 0) {
      e.bases.reserve((size_t)(st.st_size / 2));
      size_t est_recs = (size_t)(st.st_size / 60) + 16;
      e.off.reserve(est_recs + 1);
      e.rec_off.reserve(est_recs);
      if (end == 0 && !index_only) e.names.reserve(est_recs);
    }
  }
  LineReader lr(in_f);
  FILE* out = nullptr;  // opened on the first non-canonical record
  std::string buf, iqual;
  buf.reserve(1 << 20);
  e.off.push_back(0);
  int64_t wpos = 0;
  long i = 0;
  char tmp[64];
  bool canon = true, io_fail = false;
  const char *ph, *ps, *pp, *pq;
  size_t nh, ns, np_, nq;
  while (lr.next(ph, nh)) {
    int64_t in_off = lr.off_of(ph);
    if (end == 0 && !index_only) {
      // fragment name: strip '@' and any trailing /end suffix.
      // index-only stores skip the collection entirely (10M
      // std::strings ≈ 0.6GB heap + the dominant tail write; the
      // originals hold the names and nothing in the pipeline reads
      // the .names map)
      size_t beg = nh ? 1 : 0, len = nh ? nh - 1 : 0;
      const char* slash =
          (const char*)memrchr(ph + beg, '/', len);
      e.names.emplace_back(ph + beg,
                           slash ? (size_t)(slash - ph - beg) : len);
    }
    bool rec_canon = false;
    if (canon) {
      int hn = CanonHeader(tmp, i, end + 1);
      rec_canon = (long)nh == hn && memcmp(ph, tmp, hn) == 0;
    }
    if (!lr.next(ps, ns)) {
      if (end == 0 && !index_only)
        e.names.pop_back();  // header without a record
      break;
    }
    e.bases.insert(e.bases.end(), ps, ps + ns);
    e.off.push_back((int64_t)e.bases.size());
    // Each view must be validated before the next lr.next() call — a
    // buffer refill memmoves the window and invalidates older views
    // (a stale pp here used to randomly fail the canonicality check
    // once per ~buffer boundary, silently forcing the full rewrite).
    bool plus_ok = lr.next(pp, np_) && np_ == 1 && pp[0] == '+';
    if (!lr.next(pq, nq)) nq = 0;
    if (canon && rec_canon) {
      if (iqual.size() < nq) iqual.assign(nq, 'I');
      size_t seq_len = (size_t)(e.off[i + 1] - e.off[i]);
      rec_canon = plus_ok && nq == seq_len &&
                  memcmp(pq, iqual.data(), nq) == 0;
    }
    if (canon && !rec_canon) {
      if (!index_only) {
        out = fopen(out_path, "w");
        if (!out || (wpos > 0 && !CopyRange(in_path, out, wpos))) {
          io_fail = true;
          break;
        }
      }
      canon = false;
    }
    e.rec_off.push_back(index_only ? in_off : wpos);
    int64_t lo = e.off[i], hi = e.off[i + 1];
    int n = CanonHeader(tmp, i, end + 1) + 1;
    tmp[n - 1] = '\n';
    if (!canon && !index_only) {
      buf.append(tmp, n);
      buf.append(e.bases.data() + lo, hi - lo);
      buf += "\n+\n";
      buf.append((size_t)(hi - lo), 'I');
      buf += '\n';
      if (buf.size() > (1 << 20) - 4096) {
        fwrite(buf.data(), 1, buf.size(), out);
        buf.clear();
      }
    }
    wpos += n + (hi - lo) * 2 + 4;
    i++;
  }
  fclose(in_f);
  if (IngestTiming())
    fprintf(stderr, "[ingest-timing] end%d parse loop %.2fs (%ld recs)\n",
            end, IngestNow() - t0, i);
  if (io_fail) {
    if (out) fclose(out);
    return;
  }
  if (index_only && !canon) {
    // original-backed store: no renamed copy on disk — rec_off holds
    // input-file offsets; retrieval synthesizes the canonical record
    // (header "@<i>/<end>", seq, "+", 'I' quals) on pread.  Kill any
    // stale renamed file from a previous rewrite-mode run so path
    // resolution can never serve mismatched ids.
    unlink(out_path);
    e.backed = true;
    e.ok = true;
    return;
  }
  if (!canon) {
    fwrite(buf.data(), 1, buf.size(), out);
    fclose(out);
    e.ok = true;
    return;
  }
  // fully canonical input: link (or copy) it into place
  struct stat st;
  bool exact = stat(in_path, &st) == 0 && (int64_t)st.st_size == wpos;
  unlink(out_path);
  if (exact && link(in_path, out_path) == 0) {
    e.ok = true;
    return;
  }
  if (index_only && i > 0) {
    // canonical records but the link failed (cross-device) or the file
    // tail differs: serve it original-backed too — offsets of the i
    // complete records are valid regardless of trailing junk
    e.backed = true;
    e.ok = true;
    return;
  }
  out = fopen(out_path, "w");
  if (!out) return;
  if (exact) {
    e.ok = CopyRange(in_path, out, wpos);
  } else if (i == 0) {
    e.ok = true;  // empty input -> empty renamed file
  } else {
    // records are canonical but the file tail differs (missing final
    // newline / trailing junk): copy the verbatim prefix, rewrite the
    // last record canonically
    int64_t last = e.rec_off.back();
    int64_t lo = e.off[i - 1], hi = e.off[i];
    e.ok = CopyRange(in_path, out, last);
    if (e.ok) {
      int n = snprintf(tmp, sizeof tmp, "@%ld/%d\n", i - 1, end + 1);
      fwrite(tmp, 1, n, out);
      fwrite(e.bases.data() + lo, 1, hi - lo, out);
      fwrite("\n+\n", 1, 3, out);
      std::string q(hi - lo, 'I');
      fwrite(q.data(), 1, q.size(), out);
      fwrite("\n", 1, 1, out);
    }
  }
  fclose(out);
}
}  // namespace fastq_ingest

extern "C" {

// dims out: n1, n2, max_width, end1_backed, end2_backed.  Returns
// handle or null on IO error.  index_only=1: non-canonical inputs are
// NOT rewritten — the .fqi gets a v2 header and offsets into the
// ORIGINAL files (kills the ~GB renamed-fastq write, the largest write
// of a run, on a slow filesystem the whole ingest cost).
void* dt_fastq_ingest(const char* fq1, const char* fq2, const char* out1,
                      const char* out2, const char* fqi_path,
                      const char* names_path, int index_only,
                      int64_t* dims) {
  auto* h = new fastq_ingest::Handle();
  double t0 = fastq_ingest::IngestTiming() ? fastq_ingest::IngestNow()
                                           : 0.0;
  bool idx = index_only != 0;
  std::thread t1(fastq_ingest::ParseAndWrite, fq1, out1, 0,
                 std::ref(h->ends[0]), idx);
  std::thread t2(fastq_ingest::ParseAndWrite, fq2, out2, 1,
                 std::ref(h->ends[1]), idx);
  t1.join();
  t2.join();
  if (fastq_ingest::IngestTiming()) {
    fprintf(stderr, "[ingest-timing] parse threads %.2fs\n",
            fastq_ingest::IngestNow() - t0);
    t0 = fastq_ingest::IngestNow();
  }
  if (!h->ends[0].ok || !h->ends[1].ok) {
    delete h;
    return nullptr;
  }
  // the three tail passes are independent once both parses joined:
  // names map, .fqi offsets, and the max-width scan run as concurrent
  // threads (each writes its own file / variable)
  long n1 = (long)h->ends[0].rec_off.size();
  long n2 = (long)h->ends[1].rec_off.size();
  int64_t w = 0;
  // by-value captures: these writers outlive this call (joined in
  // dt_fastq_free so they overlap the caller's matrix copies)
  std::string names_p(names_path), fqi_p(fqi_path);
  h->names_t = std::thread([h, idx, names_p]() {
    const char* names_path = names_p.c_str();
    // names map (end-1 fragment names); formatted into per-range
    // buffers in parallel, written in order (byte-identical to the
    // fprintf loop).  index-only stores skip it — nothing in the
    // pipeline reads the map, and the write dominated the warm ingest
    // tail (~2.5s at 10M pairs); a stale map from a previous eager run
    // is removed so it can never pair with a new store.
    if (idx) {
      unlink(names_path);
      return;
    }
    FILE* nf = fopen(names_path, "w");
    if (!nf) return;
    const auto& names = h->ends[0].names;
    long n = (long)names.size();
    int nt = (int)std::min<long>(2, std::max<long>(1, n / 250000));
    std::vector<std::string> parts(nt);
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; t++)
      ts.emplace_back([&, t]() {
        long lo = n * t / nt, hi = n * (t + 1) / nt;
        std::string& s = parts[t];
        s.reserve((size_t)(hi - lo) * 24);
        char tmp[32];
        for (long i = lo; i < hi; i++) {
          s.append(tmp, (size_t)(fastq_ingest::PutDecimal(
                            tmp, (unsigned long)i) - tmp));
          s += '\t';
          s += names[i];
          s += '\n';
        }
      });
    for (auto& th : ts) th.join();
    for (auto& s : parts)
      if (!s.empty()) fwrite(s.data(), 1, s.size(), nf);
    fclose(nf);
  });
  h->fqi_t = std::thread([h, fqi_p, n1, n2]() {
    // .fqi: two packed little-endian int64 offsets per fragment
    // (ReadIndex.cpp:67-129); 0 for a missing end.  When either end is
    // original-backed a 16-byte v2 header leads the array: magic
    // "DFQI2\0\0\0" + uint64 per-end backed flags (v1 files always
    // start with int64 0 — fragment 0 end 1's offset — so the magic
    // can never collide with a v1 payload).
    FILE* ff = fopen(fqi_p.c_str(), "wb");
    if (!ff) return;
    bool b0 = h->ends[0].backed, b1 = h->ends[1].backed;
    if (b0 || b1) {
      char magic[8] = {'D', 'F', 'Q', 'I', '2', 0, 0, 0};
      uint64_t flags = (b0 ? 1u : 0u) | (b1 ? 2u : 0u);
      fwrite(magic, 1, 8, ff);
      fwrite(&flags, sizeof(flags), 1, ff);
    }
    long n = std::max(n1, n2);
    std::vector<int64_t> recs((size_t)n * 2);
    // miss marker for an absent end: 0 in v1 (offset 0 never holds a
    // fragment>0 record and the id check rejects it), -1 when that end
    // is backed (offset 0 is the original file's first record and the
    // id check is relaxed, so 0 would silently serve fragment 0's read)
    int64_t miss0 = b0 ? -1 : 0, miss1 = b1 ? -1 : 0;
    for (long i = 0; i < n; i++) {
      recs[(size_t)i * 2] = i < n1 ? h->ends[0].rec_off[i] : miss0;
      recs[(size_t)i * 2 + 1] = i < n2 ? h->ends[1].rec_off[i] : miss1;
    }
    fwrite(recs.data(), sizeof(int64_t), recs.size(), ff);
    fclose(ff);
  });
  for (int end = 0; end < 2; end++) {
    auto& e = h->ends[end];
    for (size_t i = 0; i + 1 < e.off.size(); i++)
      w = std::max<int64_t>(w, e.off[i + 1] - e.off[i]);
  }
  if (fastq_ingest::IngestTiming())
    fprintf(stderr, "[ingest-timing] width scan %.2fs "
            "(names/fqi writers deferred to dt_fastq_free)\n",
            fastq_ingest::IngestNow() - t0);
  dims[0] = n1;
  dims[1] = n2;
  dims[2] = w;
  dims[3] = h->ends[0].backed ? 1 : 0;
  dims[4] = h->ends[1].backed ? 1 : 0;
  return h;
}

// copy one end's reads into a (n, width) uint8 char matrix + lens
void dt_fastq_matrix(void* handle, int end, uint8_t* out, int32_t* lens,
                     long width) {
  auto* h = (fastq_ingest::Handle*)handle;
  auto& e = h->ends[end];
  long n = (long)e.off.size() - 1;
  int nt = (int)std::min<long>(4, std::max<long>(1, n / 250000));
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; t++)
    ts.emplace_back([&, t]() {
      long lo_i = n * t / nt, hi_i = n * (t + 1) / nt;
      for (long i = lo_i; i < hi_i; i++) {
        int64_t lo = e.off[i], hi = e.off[i + 1];
        int64_t len = std::min<int64_t>(hi - lo, width);
        memcpy(out + (size_t)i * width, e.bases.data() + lo, len);
        lens[i] = (int32_t)len;
      }
    });
  for (auto& th : ts) th.join();
}

void dt_fastq_free(void* handle) {
  auto* h = (fastq_ingest::Handle*)handle;
  if (h->names_t.joinable()) h->names_t.join();
  if (h->fqi_t.joinable()) h->fqi_t.join();
  delete h;
}

}  // extern "C"

namespace fastq_ingest {

// Offset-only scan of one already-renamed fastq: record i must carry
// the canonical header "@<i>/<end1>" (the fragment-id == ordinal
// contract the .fqi depends on); the separator/quality lines may hold
// anything (real quality strings are fine — the index reader preads a
// whole record and re-parses it).  Collects record header byte
// offsets; ok=false on the first name divergence, record truncation,
// or IO error (the caller then falls back to the full parse).
inline void ScanCanonicalOffsets(const char* in_path, int end1,
                                 std::vector<int64_t>* rec_off, bool* ok) {
  *ok = false;
  FILE* f = fopen(in_path, "rb");
  if (!f) return;
  {
    struct stat st;
    if (stat(in_path, &st) == 0 && st.st_size > 0)
      rec_off->reserve((size_t)(st.st_size / 60) + 16);
  }
  LineReader lr(f);
  int64_t pos = 0;
  long i = 0;
  char tmp[64];
  const char *ph, *ps, *pp, *pq;
  size_t nh, ns, np_, nq;
  while (lr.next(ph, nh)) {
    int hn = CanonHeader(tmp, i, end1);
    if ((long)nh != hn || memcmp(ph, tmp, hn) != 0) {
      fclose(f);
      return;
    }
    if (!lr.next(ps, ns) || !lr.next(pp, np_) || np_ < 1 ||
        pp[0] != '+') {
      fclose(f);
      return;
    }
    if (!lr.next(pq, nq)) nq = 0;
    rec_off->push_back(pos);
    pos += (int64_t)nh + (int64_t)ns + (int64_t)np_ + (int64_t)nq + 4;
    i++;
  }
  fclose(f);
  *ok = true;
}

}  // namespace fastq_ingest

extern "C" {

// Build the .fqi offset index (two little-endian int64 record offsets
// per fragment, 0 for a missing end — the dt_fastq_ingest byte format)
// over fastqs that are ALREADY in renamed form, without rewriting or
// materializing them: a pure IO-bound scan, so flows that imported
// renamed fastqs from elsewhere (no index_paired_fastq stage) get
// pread-based candidate retrieval instead of a whole-library parse.
// Returns 0 ok; 2 when either file is not in canonical renamed form
// (caller must fall back); 1 on IO error.
int dt_fqi_build(const char* fq1, const char* fq2, const char* fqi_path) {
  std::vector<int64_t> r1, r2;
  bool ok1 = false, ok2 = false;
  std::thread t1(fastq_ingest::ScanCanonicalOffsets, fq1, 1, &r1, &ok1);
  std::thread t2(fastq_ingest::ScanCanonicalOffsets, fq2, 2, &r2, &ok2);
  t1.join();
  t2.join();
  if (!ok1 || !ok2) return 2;
  FILE* ff = fopen(fqi_path, "wb");
  if (!ff) return 1;
  size_t n = std::max(r1.size(), r2.size());
  std::vector<int64_t> recs(n * 2);
  for (size_t i = 0; i < n; i++) {
    recs[i * 2] = i < r1.size() ? r1[i] : 0;
    recs[i * 2 + 1] = i < r2.size() ? r2[i] : 0;
  }
  bool wok = recs.empty() ||
             fwrite(recs.data(), sizeof(int64_t), recs.size(), ff) ==
                 recs.size();
  return (fclose(ff) == 0 && wok) ? 0 : 1;
}

}  // extern "C"

// ---------------------------------------------------------------------
// K-way merge of sorted packed (key<<32|pos) seed-table chunks into
// split keys/positions outputs — the bounded-memory genome-scale index
// build (per-chromosome chunk tables merge in packed-value order, which
// is exactly (key, global position) ascending; byte-identical to the
// monolithic build).  Reference-length scaling per SURVEY §5: the
// reference bounds chromosome size with 13-bit bins and per-chromosome
// gmap indices; here the build is chunked and the merged table mmaps.
// ---------------------------------------------------------------------

extern "C" {

long dt_merge_seed_chunks(const uint64_t** chunks, const long* sizes,
                          int n_chunks, uint64_t* out_keys,
                          int64_t* out_positions) {
  // simple binary-heap merge; ties prefer the lower chunk index, which
  // preserves ascending global position within a key
  struct Item {
    uint64_t value;
    int chunk;
  };
  auto greater = [](const Item& a, const Item& b) {
    if (a.value != b.value) return a.value > b.value;
    return a.chunk > b.chunk;
  };
  std::vector<Item> heap;
  std::vector<long> idx(n_chunks, 0);
  heap.reserve(n_chunks);
  for (int c = 0; c < n_chunks; c++)
    if (sizes[c] > 0) heap.push_back({chunks[c][0], c});
  std::make_heap(heap.begin(), heap.end(), greater);
  long n = 0;
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), greater);
    Item it = heap.back();
    heap.pop_back();
    out_keys[n] = it.value >> 32;
    out_positions[n] = (int64_t)(it.value & 0xFFFFFFFFULL);
    n++;
    long next = ++idx[it.chunk];
    if (next < sizes[it.chunk]) {
      heap.push_back({chunks[it.chunk][next], it.chunk});
      std::push_heap(heap.begin(), heap.end(), greater);
    }
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Native read-stats pass over the paired concordant SAM
// (stats/readstats.py::read_stats_from_sam contract; read_stats.pl):
// rows come in mate pairs, keep flag-0x2 same-reference pairs,
// fragment length = |isize|.
// ---------------------------------------------------------------------

extern "C" {

// out_scalars: n, sum, sumsq (doubles to mirror the Python float
// accumulation exactly).  out_lengths: up to cap distinct read lengths.
// Returns the count of distinct lengths, -2 on mate pairing error,
// -1 on IO error.
long dt_read_stats(const char* sam_path, double* out_scalars,
                   int32_t* out_lengths, int cap) {
  GzIn in;
  if (!in.open(sam_path)) return -1;
  std::string l1, l2;
  double s = 0.0, ss = 0.0;
  long n = 0;
  std::set<int32_t> lengths;

  auto split10 = [](const std::string& line, const char* tabs[10]) {
    int nt = 0;
    for (const char* q = line.c_str(); *q && nt < 10; q++)
      if (*q == '\t') tabs[nt++] = q;
    return nt;
  };
  while (in.getline(l1)) {
    if (!l1.empty() && l1[0] == '@') continue;
    if (!in.getline(l2)) break;
    const char* t1[10];
    const char* t2[10];
    if (split10(l1, t1) < 10 || split10(l2, t2) < 10) return -1;
    // qname up to a trailing /N
    std::string q1(l1.c_str(), t1[0] - l1.c_str());
    std::string q2(l2.c_str(), t2[0] - l2.c_str());
    size_t s1 = q1.rfind('/');
    if (s1 != std::string::npos) q1.resize(s1);
    size_t s2 = q2.rfind('/');
    if (s2 != std::string::npos) q2.resize(s2);
    if (q1 != q2) return -2;
    long flag1 = atol(t1[0] + 1), flag2 = atol(t2[0] + 1);
    if (!(flag1 & 0x2) || !(flag2 & 0x2)) continue;
    std::string r1(t1[1] + 1, t1[2] - t1[1] - 1);
    std::string r2(t2[1] + 1, t2[2] - t2[1] - 1);
    if (r1 != r2) continue;
    long isize = atol(t1[7] + 1);
    if (isize < 0) isize = -isize;
    s += (double)isize;
    ss += (double)isize * (double)isize;
    n++;
    lengths.insert((int32_t)(t1[9] - t1[8] - 1));
    lengths.insert((int32_t)(t2[9] - t2[8] - 1));
  }
  out_scalars[0] = (double)n;
  out_scalars[1] = s;
  out_scalars[2] = ss;
  int i = 0;
  for (int32_t v : lengths) {
    if (i >= cap) break;
    out_lengths[i++] = v;
  }
  return (long)lengths.size();
}

// Shard-merge fragment-id globalization (defuse_run.pl:387-400 merge
// semantics; byte-identical to parallel/shard.py::globalize): rewrite
// the leading fragment id by +offset, preserving an optional "/end"
// qname suffix, append to dst.  Reads transparently through gzip
// (GzIn); when dst ends in .gz the rewritten shard is appended as one
// gzip member (concatenated members are one valid stream).  style:
// 0 = bare id ("frag"/"sam"), 1 = "frag/end".  Returns line count,
// -1 on IO error, -2 on a malformed id line.
long dt_globalize_ids(const char* src, const char* dst, long offset,
                      int style) {
  GzIn in;
  if (!in.open(src)) return -1;
  FILE* out = fopen(dst, "ab");
  if (!out) return -1;
  std::string line, buf;
  buf.reserve(1 << 22);
  char tmp[32];
  long count = 0;
  long rc = 0;
  while (in.getline(line)) {
    const char* p = line.c_str();
    char* endp = nullptr;
    long id = strtol(p, &endp, 10);
    if (endp == p) {
      rc = -2;
      break;
    }
    if (style == 1) {
      if (*endp != '/') {
        rc = -2;
        break;
      }
    } else if (*endp != '\t') {
      rc = -2;
      break;
    }
    snprintf(tmp, sizeof tmp, "%ld", id + offset);
    buf += tmp;
    buf.append(endp, line.c_str() + line.size() - endp);
    buf += '\n';
    count++;
  }
  if (rc == 0) {
    if (EndsWithGz(dst)) {
      std::string z;
      if (!GzipMember(buf, z)) rc = -1;
      else if (fwrite(z.data(), 1, z.size(), out) != z.size()) rc = -1;
    } else if (!buf.empty() &&
               fwrite(buf.data(), 1, buf.size(), out) != buf.size()) {
      rc = -1;
    }
  }
  fclose(out);
  return rc < 0 ? rc : count;
}

// Covariance-sample merge (merge_cov_samples.pl:23-49; bit-exact twin
// of stats/pvalues.py::cov_samples_merge): parse "marker\tvalue" rows
// (strtol/strtod — correctly rounded like Python float()), group by
// marker preserving file order, then for each marker with >=2 samples
// in ascending order draw two with the exact drand48 stream and
// accumulate in the oracle's operation order.  out[0]=mean, out[1]=cov.
// Returns marker-pair count, -1 on IO/parse error, -2 when count<=100
// (the reference hard-aborts there).
// Merge core over in-memory sample arrays (file order): counting-sort
// grouping, exact drand48 stream, oracle-order accumulation — shared
// by the file reader below and the fused calccov+merge path.
inline long CovMergeArrays(const std::vector<int64_t>& ids,
                           const std::vector<double>& vals, long seed,
                           double* out) {
  int64_t max_id = -1;
  for (int64_t id : ids)
    if (id > max_id) max_id = id;
  // Two-pass radix grouping, stable by construction: pass 1 is a
  // stable counting sort on the id HIGH bits (≤256 buckets — the
  // destination cursor jumps across at most 256 streams, each written
  // sequentially), pass 2 counting-sorts each bucket locally (bucket
  // payload and its counts slice stay cache-resident).  The previous
  // single-pass counting sort scattered randomly across the whole
  // grouped array — ~350MB of cache-miss writes at the 50M-pair
  // benchmark's 44M samples, the dominant serial cost of the
  // distributed tail's rank-0 merge.  Ordering is IDENTICAL: stable
  // by id overall, so within-marker file order, the ascending-marker
  // drand48 stream, and the accumulation sequence are all unchanged
  // (bit-exact result).
  const int64_t n_ids = max_id + 1;
  const size_t n = ids.size();
  int shift = 0;
  while ((n_ids >> shift) > 256) shift++;
  const int n_buckets = n_ids > 0 ? (int)(((n_ids - 1) >> shift) + 1) : 0;
  std::vector<int64_t> bcount((size_t)n_buckets + 1, 0);
  for (int64_t id : ids) bcount[(size_t)(id >> shift) + 1]++;
  for (int b = 1; b <= n_buckets; b++) bcount[b] += bcount[b - 1];
  std::vector<int64_t> ids2(n);
  std::vector<double> vals2(n);
  {
    std::vector<int64_t> cur(bcount.begin(), bcount.end() - 1);
    for (size_t i = 0; i < n; i++) {
      int64_t at = cur[ids[i] >> shift]++;
      ids2[at] = ids[i];
      vals2[at] = vals[i];
    }
  }
  uint64_t x = (((uint64_t)seed & 0xFFFFFFFFull) << 16) | 0x330E;
  const uint64_t A = 0x5DEECE66Dull, C = 0xB;
  const uint64_t MASK = ((uint64_t)1 << 48) - 1;
  auto drand = [&]() {
    x = (A * x + C) & MASK;
    return (double)x / (double)((uint64_t)1 << 48);
  };
  double s1 = 0.0, s2 = 0.0, cross = 0.0, count = 0.0;
  const int64_t span = (int64_t)1 << shift;
  std::vector<int64_t> counts((size_t)span + 1);
  std::vector<double> grouped;
  for (int b = 0; b < n_buckets; b++) {
    int64_t lo = bcount[b], hi = bcount[b + 1];
    if (lo == hi) continue;
    const int64_t id0 = (int64_t)b << shift;
    const int64_t width =
        std::min<int64_t>(span, n_ids - id0);
    std::fill(counts.begin(), counts.begin() + width + 1, 0);
    for (int64_t i = lo; i < hi; i++) counts[ids2[i] - id0 + 1]++;
    for (int64_t m = 1; m <= width; m++) counts[m] += counts[m - 1];
    grouped.resize((size_t)(hi - lo));
    {
      std::vector<int64_t> cur(counts.begin(), counts.begin() + width);
      for (int64_t i = lo; i < hi; i++)
        grouped[(size_t)cur[ids2[i] - id0]++] = vals2[i];
    }
    for (int64_t m = 0; m < width; m++) {
      int64_t base = counts[m];
      int64_t cnt = counts[m + 1] - base;
      if (cnt < 2) continue;
      double a = grouped[base + (int64_t)(drand() * (double)cnt)];
      double bb = grouped[base + (int64_t)(drand() * (double)cnt)];
      s1 += a;
      s2 += bb;
      cross += a * bb;
      count += 1;
    }
  }
  if (count <= 100) return -2;
  out[0] = (s1 + s2) / (2.0 * count);
  out[1] = (cross - s1 * s2 / count) / count;
  return (long)count;
}

long dt_cov_merge(const char* path, long seed, double* out) {
  GzIn in;
  if (!in.open(path)) return -1;
  std::vector<int64_t> ids;
  std::vector<double> vals;
  std::string line;
  while (in.getline(line)) {
    if (line.empty()) continue;
    char* endp = nullptr;
    long id = strtol(line.c_str(), &endp, 10);
    if (!endp || *endp != '\t' || id < 0) return -1;
    double v = strtod(endp + 1, nullptr);
    ids.push_back(id);
    vals.push_back(v);
  }
  return CovMergeArrays(ids, vals, seed, out);
}

// Binary multi-part covariance merge for the distributed pipeline
// tail: each rank emits a COVBN001 part for its own pair-table part
// (dt_calccov_tbl bin_path), and rank 0 merges the parts IN RANK
// ORDER — the concatenated sample sequence is identical to a single
// scan of the concatenated table, so the drand48 stream and
// accumulation order (hence the merged mean/cov bits) match the
// single-process fused path exactly.  `paths` is ';'-joined; out is 6
// doubles (mean, cov per kind), counts 3 longs (-2: insufficient).
long dt_cov_merge_bin(const char* paths, long seed, double* out,
                      long* counts) {
  std::vector<int64_t> ids[3];
  std::vector<double> vals[3];
  std::string all(paths ? paths : "");
  size_t start = 0;
  while (start <= all.size()) {
    size_t end = all.find(';', start);
    if (end == std::string::npos) end = all.size();
    std::string path = all.substr(start, end - start);
    start = end + 1;
    if (path.empty()) continue;
    FILE* f = fopen(path.c_str(), "r");
    if (!f) return -1;
    int64_t magic = 0, nk[3] = {0, 0, 0};
    bool ok = fread(&magic, 8, 1, f) == 1 &&
              magic == 0x434f56424e303031LL && fread(nk, 8, 3, f) == 3;
    for (int k = 0; ok && k < 3; k++) {
      if (nk[k] < 0) {
        ok = false;
        break;
      }
      size_t base_i = ids[k].size(), base_v = vals[k].size();
      ids[k].resize(base_i + (size_t)nk[k]);
      vals[k].resize(base_v + (size_t)nk[k]);
      ok = fread(ids[k].data() + base_i, 8, (size_t)nk[k], f) ==
               (size_t)nk[k] &&
           fread(vals[k].data() + base_v, 8, (size_t)nk[k], f) ==
               (size_t)nk[k];
    }
    fclose(f);
    if (!ok) return -1;
  }
  std::vector<std::thread> ms;
  for (int k = 0; k < 3; k++)
    ms.emplace_back([&, k]() {
      counts[k] = CovMergeArrays(ids[k], vals[k], seed, out + 2 * k);
    });
  for (auto& th : ms) th.join();
  long total = 0;
  for (int k = 0; k < 3; k++) total += ids[k].size();
  return total;
}

// Single-kind variant of dt_cov_merge_bin (kind 0=span 1=pos 2=min):
// seeks past the other kinds' sections, so merging one kind reads a
// third of the bytes.  The distributed tail fans the three independent
// kind merges across ranks; each result is bit-identical to the
// corresponding entry of the full merge.
long dt_cov_merge_bin_kind(const char* paths, int kind, long seed,
                           double* out) {
  if (kind < 0 || kind > 2) return -1;
  std::vector<int64_t> ids;
  std::vector<double> vals;
  std::string all(paths ? paths : "");
  size_t start = 0;
  while (start <= all.size()) {
    size_t end = all.find(';', start);
    if (end == std::string::npos) end = all.size();
    std::string path = all.substr(start, end - start);
    start = end + 1;
    if (path.empty()) continue;
    FILE* f = fopen(path.c_str(), "r");
    if (!f) return -1;
    int64_t magic = 0, nk[3] = {0, 0, 0};
    bool ok = fread(&magic, 8, 1, f) == 1 &&
              magic == 0x434f56424e303031LL && fread(nk, 8, 3, f) == 3 &&
              nk[0] >= 0 && nk[1] >= 0 && nk[2] >= 0;
    if (ok) {
      int64_t skip = 0;
      for (int k = 0; k < kind; k++) skip += 16 * nk[k];
      ok = fseek(f, (long)skip, SEEK_CUR) == 0;
    }
    if (ok) {
      size_t base = ids.size();
      ids.resize(base + (size_t)nk[kind]);
      vals.resize(base + (size_t)nk[kind]);
      ok = fread(ids.data() + base, 8, (size_t)nk[kind], f) ==
               (size_t)nk[kind] &&
           fread(vals.data() + base, 8, (size_t)nk[kind], f) ==
               (size_t)nk[kind];
    }
    fclose(f);
    if (!ok) return -1;
  }
  return CovMergeArrays(ids, vals, seed, out);
}

// Text multi-file variant (same rank-order contract as
// dt_cov_merge_bin, for externally-materialized sample files).
long dt_cov_merge_multi(const char* paths, long seed, double* out) {
  std::vector<int64_t> ids;
  std::vector<double> vals;
  std::string all(paths ? paths : "");
  size_t start = 0;
  while (start <= all.size()) {
    size_t end = all.find(';', start);
    if (end == std::string::npos) end = all.size();
    std::string path = all.substr(start, end - start);
    start = end + 1;
    if (path.empty()) continue;
    GzIn in;
    if (!in.open(path.c_str())) return -1;
    std::string line;
    while (in.getline(line)) {
      if (line.empty()) continue;
      char* endp = nullptr;
      long id = strtol(line.c_str(), &endp, 10);
      if (!endp || *endp != '\t' || id < 0) return -1;
      double v = strtod(endp + 1, nullptr);
      ids.push_back(id);
      vals.push_back(v);
    }
  }
  return CovMergeArrays(ids, vals, seed, out);
}

// Batch SimpleAligner scores (tools/SimpleAligner.cpp:23-63 contract,
// integer-exact): row 0 zero, gap-accumulating borders, max interior
// cell.  One DP per (reference window, sequence) row, threaded over
// rows — the localalign concordance screen (defuse_run.pl:489-505)
// scores ~2k windows of ~2kb each.
long dt_localalign_batch(const char* refs, const int64_t* ref_off,
                         const char* seqs, const int64_t* seq_off,
                         long n_rows, int match, int mismatch, int gap,
                         int32_t* scores_out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; t++)
    ts.emplace_back([&, t]() {
      std::vector<int32_t> prev, col;
      long lo = n_rows * t / n_threads;
      long hi = n_rows * (t + 1) / n_threads;
      for (long row = lo; row < hi; row++) {
        const char* r = refs + ref_off[row];
        long n_ref = ref_off[row + 1] - ref_off[row];
        const char* q = seqs + seq_off[row];
        long n_seq = seq_off[row + 1] - seq_off[row];
        if (n_ref == 0 || n_seq == 0) {
          scores_out[row] = 0;
          continue;
        }
        prev.assign(n_ref + 1, 0);
        col.resize(n_ref + 1);
        int32_t best = 0;
        for (long j = 1; j <= n_seq; j++) {
          char qc = q[j - 1];
          col[0] = gap * (int32_t)j;
          for (long i = 1; i <= n_ref; i++) {
            int32_t sub = (r[i - 1] == qc) ? match : mismatch;
            int32_t v = std::max(prev[i - 1] + sub, prev[i] + gap);
            v = std::max(v, col[i - 1] + gap);
            col[i] = v;
            if (v > best) best = v;
          }
          prev.swap(col);
        }
        scores_out[row] = best;
      }
    });
  for (auto& th : ts) th.join();
  return n_rows;
}

// dt_read_stats over the binary pair table: identical accumulation
// order to the SAM scan (records are in fragment order, the same order
// pair.sam rows appear), so the float sums are bit-equal.
// release the cached pair table (multi-GB at scale)
void dt_pairtbl_cache_clear() {
  std::lock_guard<std::mutex> lk(alignjob::TblCacheMu());
  alignjob::TblCache() = alignjob::TblCacheEntry{};
}

long dt_read_stats_tbl(const char* tbl_path, double* out_scalars,
                       int32_t* out_lengths, int cap) {
  using namespace alignjob;
  auto tp = GetPairTblCached(tbl_path);
  if (!tp) return -1;
  const PairTbl& t = *tp;
  double s = 0.0, ss = 0.0;
  long n = 0;
  // read lengths are tiny ints: a bitmap beats a std::set insert pair
  // per record (2 x 100M tree inserts cost ~10s at scale); lengths
  // beyond the bitmap fall back to the set (unbounded correctness)
  constexpr int kMaxLen = 1 << 16;
  std::vector<uint64_t> seen(kMaxLen / 64, 0);
  std::set<int32_t> big;
  for (const PairRec& r : t.recs) {
    long isize = r.isize;
    if (isize < 0) isize = -isize;
    s += (double)isize;
    ss += (double)isize * (double)isize;
    n++;
    for (int32_t v : {r.len1, r.len2}) {
      if (0 <= v && v < kMaxLen)
        seen[v >> 6] |= 1ULL << (v & 63);
      else
        big.insert(v);
    }
  }
  out_scalars[0] = (double)n;
  out_scalars[1] = s;
  out_scalars[2] = ss;
  // emit ascending, exactly like set iteration (negatives first from
  // the fallback set, then the bitmap, then oversized values)
  long total = 0;
  int i = 0;
  auto emit = [&](int32_t v) {
    if (i < cap) out_lengths[i++] = v;
    total++;
  };
  for (int32_t v : big)
    if (v < 0) emit(v);
  for (int32_t v = 0; v < kMaxLen; v++)
    if (seen[v >> 6] >> (v & 63) & 1) emit(v);
  for (int32_t v : big)
    if (v >= kMaxLen) emit(v);
  return total;
}

// dt_calccov over the binary pair table, threaded by record ranges
// with in-order buffer writes — byte-identical span/pos/min sample
// files to the SAM-scanning dt_calccov (each record is one flushed
// group; per-record arithmetic is replicated exactly).
// merged_out (6 doubles: mean,cov for span/pos/min) + merged_counts
// (3 longs; -2 = insufficient samples) optionally receive the fused
// covariance merge — same sample order and %.6g-quantized values as
// reading the emitted files back through dt_cov_merge, so the results
// are bit-identical while skipping the ~100MB-per-kind re-parse.
long dt_calccov_tbl(const char* tbl_path, const char* names,
                    const int64_t* name_off, int n_refs,
                    const int32_t* marker_ref, const int64_t* marker_pos,
                    long n_markers, long trim_length, long anchor,
                    const char* span_path, const char* pos_path,
                    const char* min_path, int n_threads,
                    long merge_seed, double* merged_out,
                    long* merged_counts, const char* bin_path) {
  using namespace alignjob;
  constexpr int64_t kBin = 10000;  // calccov.py BIN_SPACING
  auto tblp = GetPairTblCached(tbl_path);
  if (!tblp) return -1;
  const PairTbl& tbl = *tblp;
  if (n_threads < 1) n_threads = 1;
  const bool timing = getenv("DT_TIMING") != nullptr;
  auto tick = std::chrono::steady_clock::now();
  auto mark = [&](const char* stage) {
    if (!timing) return;
    auto now = std::chrono::steady_clock::now();
    fprintf(stderr, "[dt_calccov] %s: %.3fs\n", stage,
            std::chrono::duration<double>(now - tick).count());
    tick = now;
  };

  std::unordered_map<std::string, int32_t> ref_of;
  ref_of.reserve(n_refs * 2);
  for (int i = 0; i < n_refs; i++)
    ref_of.emplace(std::string(names + name_off[i],
                               names + name_off[i + 1]), i);
  // table seq id -> marker ref id (-1: transcript has no markers)
  int64_t n_names = (int64_t)tbl.name_off.size() - 1;
  std::vector<int32_t> seq2ref(n_names, -1);
  for (int64_t i = 0; i < n_names; i++) {
    auto it = ref_of.find(tbl.blob.substr(
        tbl.name_off[i], tbl.name_off[i + 1] - tbl.name_off[i]));
    if (it != ref_of.end()) seq2ref[i] = it->second;
  }
  // per-ref position-sorted marker lists: a contained() query becomes
  // one binary search + a short scan.  Hits are re-sorted to ascending
  // marker index, so the emitted sample set and order are identical to
  // the previous bin-hash formulation (the caller's exact-position
  // filter made bin granularity invisible in the output).
  (void)kBin;
  std::vector<std::vector<std::pair<int64_t, int32_t>>> byref(
      n_refs > 0 ? n_refs : 0);
  for (long i = 0; i < n_markers; i++)
    if (marker_ref[i] >= 0 && marker_ref[i] < n_refs)
      byref[marker_ref[i]].emplace_back(marker_pos[i], (int32_t)i);
  for (auto& v : byref) std::sort(v.begin(), v.end());

  long n_recs = (long)tbl.recs.size();
  int nt = n_threads;
  std::vector<std::string> span_bufs(nt), pos_bufs(nt), min_bufs(nt);
  std::vector<long> totals(nt, 0);
  const bool want_merge = merged_out != nullptr &&
                          merged_counts != nullptr;
  // binary sample part (distributed tail): raw (id, %.6g-quantized
  // value) arrays in emission order — parse-free input to
  // dt_cov_merge_bin, which concatenates rank parts in rank order
  const bool want_bin = bin_path && bin_path[0];
  const bool want_arrays = want_merge || want_bin;
  // NULL/empty sample paths skip text formatting and writing entirely
  // (lazy-samples mode: only the fused merge result is produced; the
  // text artifacts are materialized on demand by re-running with paths)
  const bool emit_text = span_path && span_path[0] && pos_path &&
                         pos_path[0] && min_path && min_path[0];
  std::vector<std::vector<int64_t>> span_ids(nt), pos_ids(nt),
      min_ids(nt);
  std::vector<std::vector<double>> span_vals(nt), pos_vals(nt),
      min_vals(nt);
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; t++)
    ts.emplace_back([&, t]() {
      long lo = n_recs * t / nt, hi = n_recs * (t + 1) / nt;
      std::vector<int32_t> hits;
      // fast exact "%d"/"%ld" append
      auto append_int = [](std::string& s, int64_t v) {
        char b[24];
        char* p = b + 24;
        bool neg = v < 0;
        uint64_t u = neg ? 0ull - (uint64_t)v : (uint64_t)v;
        do {
          *--p = (char)('0' + (u % 10));
          u /= 10;
        } while (u);
        if (neg) *--p = '-';
        s.append(p, (size_t)(b + 24 - p));
      };
      // "%.6g" of v/r memoized on the (integer-valued) numerator and
      // denominator — read lengths are bounded by the trim, so only a
      // few thousand distinct fractions ever occur; each is formatted
      // once by snprintf itself (text) and read back once by strtod
      // (the %.6g-quantized double the merge must consume), keeping
      // both representations exact
      std::unordered_map<uint64_t, std::pair<std::string, double>> fracs;
      auto frac6g = [&](double v,
                        double r) -> const std::pair<std::string,
                                                     double>& {
        uint64_t key = ((uint64_t)(uint32_t)(int32_t)v << 32) |
                       (uint64_t)(uint32_t)(int32_t)r;
        auto it = fracs.find(key);
        if (it != fracs.end()) return it->second;
        char b[64];
        snprintf(b, sizeof b, "%.6g", v / r);
        return fracs
            .emplace(key, std::make_pair(std::string(b),
                                         strtod(b, nullptr)))
            .first->second;
      };
      auto contained = [&](int32_t ref, int64_t s, int64_t e) {
        hits.clear();
        const auto& v = byref[ref];
        auto it = std::lower_bound(
            v.begin(), v.end(),
            std::make_pair(s, std::numeric_limits<int32_t>::min()));
        for (; it != v.end() && it->first <= e; ++it)
          hits.push_back(it->second);
        std::sort(hits.begin(), hits.end());
      };
      for (long i = lo; i < hi; i++) {
        const PairRec& r = tbl.recs[i];
        int32_t ref = seq2ref[r.seq];
        if (ref < 0) continue;
        struct {
          int64_t start, end;
        } a[2] = {{r.pos1, r.pos1 + r.len1 - 1},
                  {r.pos2, r.pos2 + r.len2 - 1}};
        int64_t unseq_start = std::min(a[0].start + trim_length,
                                       a[1].start + trim_length);
        int64_t unseq_end =
            std::max(a[0].end - trim_length, a[1].end - trim_length);
        int64_t frag_len = std::max(a[0].end, a[1].end) -
                           std::min(a[0].start, a[1].start);
        contained(ref, unseq_start, unseq_end);
        for (int32_t m : hits) {
          int64_t pos = marker_pos[m];
          if (unseq_start <= pos && pos <= unseq_end) {
            if (emit_text) {
              append_int(span_bufs[t], m);
              span_bufs[t] += '\t';
              append_int(span_bufs[t], frag_len);
              span_bufs[t] += '\n';
            }
            if (want_arrays) {
              span_ids[t].push_back(m);
              // "%ld" text round-trips integers exactly
              span_vals[t].push_back((double)frag_len);
            }
            totals[t]++;
          }
        }
        for (int e = 0; e < 2; e++) {
          int64_t a_start = a[e].start + anchor;
          int64_t a_end = a[e].end - anchor + 1;
          contained(ref, a_start, a_end);
          for (int32_t m : hits) {
            int64_t pos = marker_pos[m];
            if (a_start <= pos && pos <= a_end) {
              double v1 =
                  std::max(0.0, (double)(pos - a[e].start - anchor));
              double r1 =
                  (double)(a[e].end - a[e].start) + 1.0 - 2.0 * anchor;
              const auto& f1 = frac6g(v1, r1);
              if (emit_text) {
                append_int(pos_bufs[t], m);
                pos_bufs[t] += '\t';
                pos_bufs[t] += f1.first;
                pos_bufs[t] += '\n';
              }
              int64_t mn = std::min(pos - a[e].start - anchor,
                                    a[e].end + 1 - pos - anchor);
              double v2 = std::max(0.0, (double)mn);
              double r2 = std::floor(0.5 * ((double)(a[e].end -
                                                     a[e].start) +
                                            1.0 - 2.0 * anchor));
              const auto& f2 = frac6g(v2, r2);
              if (emit_text) {
                append_int(min_bufs[t], m);
                min_bufs[t] += '\t';
                min_bufs[t] += f2.first;
                min_bufs[t] += '\n';
              }
              if (want_arrays) {
                pos_ids[t].push_back(m);
                pos_vals[t].push_back(f1.second);
                min_ids[t].push_back(m);
                min_vals[t].push_back(f2.second);
              }
              totals[t] += 2;
            }
          }
        }
      }
    });
  for (auto& th : ts) th.join();
  mark("scan+format");

  long total = 0;
  const char* paths[3] = {span_path, pos_path, min_path};
  std::vector<std::string>* bufs[3] = {&span_bufs, &pos_bufs, &min_bufs};
  // a ".gz" destination gzips each thread buffer as its own member
  // (readers are magic-sniffing; concatenated members are one stream),
  // cutting the ~30B/sample text write by ~6x
  for (int k = 0; emit_text && k < 3; k++) {
    const bool gz = EndsWithGz(paths[k]);
    std::atomic<bool> zfail{false};
    if (gz) {
      std::vector<std::thread> zs;
      for (int t = 0; t < nt; t++)
        zs.emplace_back([&, t]() {
          std::string z;
          if (!GzipMember((*bufs[k])[t], z))
            zfail.store(true);
          (*bufs[k])[t].swap(z);
        });
      for (auto& th : zs) th.join();
      if (zfail.load()) return -1;
    }
    FILE* f = fopen(paths[k], "w");
    if (!f) return -1;
    for (int t = 0; t < nt; t++)
      if (!(*bufs[k])[t].empty())
        fwrite((*bufs[k])[t].data(), 1, (*bufs[k])[t].size(), f);
    fclose(f);
  }
  mark("write");
  if (want_bin) {
    // COVBN001: int64 magic, int64 n[3], then per kind ids[] + vals[]
    // (thread arrays concatenated in thread order = file byte order)
    std::vector<std::vector<int64_t>>* idsets[3] = {&span_ids, &pos_ids,
                                                    &min_ids};
    std::vector<std::vector<double>>* valsets[3] = {&span_vals,
                                                    &pos_vals,
                                                    &min_vals};
    FILE* f = fopen(bin_path, "w");
    if (!f) return -1;
    int64_t magic = 0x434f56424e303031LL;
    int64_t nk[3];
    for (int k = 0; k < 3; k++) {
      nk[k] = 0;
      for (int t = 0; t < nt; t++) nk[k] += (int64_t)(*idsets[k])[t].size();
    }
    bool ok = fwrite(&magic, 8, 1, f) == 1 && fwrite(nk, 8, 3, f) == 3;
    for (int k = 0; ok && k < 3; k++) {
      for (int t = 0; ok && t < nt; t++)
        if (!(*idsets[k])[t].empty())
          ok = fwrite((*idsets[k])[t].data(), 8, (*idsets[k])[t].size(),
                      f) == (*idsets[k])[t].size();
      for (int t = 0; ok && t < nt; t++)
        if (!(*valsets[k])[t].empty())
          ok = fwrite((*valsets[k])[t].data(), 8,
                      (*valsets[k])[t].size(),
                      f) == (*valsets[k])[t].size();
    }
    if (fclose(f) != 0 || !ok) return -1;
    mark("bin write");
  }
  if (want_merge) {
    // fused covariance merge over the in-memory samples: per-thread
    // arrays concatenated in thread order ARE the file byte order, and
    // values carry the %.6g-quantized doubles, so the results are
    // bit-identical to dt_cov_merge over the emitted files
    std::vector<std::vector<int64_t>>* idsets[3] = {&span_ids, &pos_ids,
                                                    &min_ids};
    std::vector<std::vector<double>>* valsets[3] = {&span_vals,
                                                    &pos_vals,
                                                    &min_vals};
    std::vector<std::thread> ms;
    for (int k = 0; k < 3; k++)
      ms.emplace_back([&, k]() {
        std::vector<int64_t> ids;
        std::vector<double> vals;
        for (int t = 0; t < nt; t++) {
          ids.insert(ids.end(), (*idsets[k])[t].begin(),
                     (*idsets[k])[t].end());
          vals.insert(vals.end(), (*valsets[k])[t].begin(),
                      (*valsets[k])[t].end());
        }
        merged_counts[k] = CovMergeArrays(ids, vals, merge_seed,
                                          merged_out + 2 * k);
      });
    for (auto& th : ms) th.join();
    mark("merge");
  }
  for (int t = 0; t < nt; t++) total += totals[t];
  return total;
}

}  // extern "C"
