// blio: native host-side IO kernels for blacklight.
//
// Plays the role the reference implements in C++ for its data loader and
// output writer (src/simulation_reader/hdf5_format_*.cpp decode loops,
// src/output_writer/zip_format.cpp CRC32 + container): the hot host-side
// byte work - big-array transposes/repacks when ingesting GRMHD dumps, and
// CRC32 for the npz/ZIP container - implemented as a small C library with
// OpenMP parallel loops, exposed to Python through ctypes. The device compute
// path stays JAX/XLA; this covers the host runtime around it.
//
// Build: make -C native   (g++ -O3 -fopenmp -shared -fPIC)

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// CRC-32 (IEEE 802.3, as used by ZIP): slicing-by-8 with per-thread chunks
// combined via crc32_combine. Replaces the reference's bitwise routine
// (zip_format.cpp:289-362) with a ~20x faster table method.
// ---------------------------------------------------------------------------

static uint32_t crc_tables[8][256];
static bool crc_init_done = false;

static void crc_init()
{
  if (crc_init_done)
    return;
  for (uint32_t i = 0; i < 256; i++)
  {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1u)));
    crc_tables[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      crc_tables[t][i] =
          (crc_tables[t - 1][i] >> 8) ^ crc_tables[0][crc_tables[t - 1][i] & 0xFF];
  crc_init_done = true;
}

static uint32_t crc32_chunk(uint32_t crc, const uint8_t *buf, uint64_t len)
{
  crc = ~crc;
  while (len >= 8)
  {
    uint32_t lo;
    uint32_t hi;
    std::memcpy(&lo, buf, 4);
    std::memcpy(&hi, buf + 4, 4);
    lo ^= crc;
    crc = crc_tables[7][lo & 0xFF] ^ crc_tables[6][(lo >> 8) & 0xFF]
        ^ crc_tables[5][(lo >> 16) & 0xFF] ^ crc_tables[4][lo >> 24]
        ^ crc_tables[3][hi & 0xFF] ^ crc_tables[2][(hi >> 8) & 0xFF]
        ^ crc_tables[1][(hi >> 16) & 0xFF] ^ crc_tables[0][hi >> 24];
    buf += 8;
    len -= 8;
  }
  while (len--)
    crc = (crc >> 8) ^ crc_tables[0][(crc ^ *buf++) & 0xFF];
  return ~crc;
}

// GF(2) matrix utilities for crc32_combine (standard zlib algorithm)
static uint32_t gf2_times(const uint32_t *mat, uint32_t vec)
{
  uint32_t sum = 0;
  while (vec)
  {
    if (vec & 1u)
      sum ^= *mat;
    vec >>= 1;
    mat++;
  }
  return sum;
}

static void gf2_square(uint32_t *square, const uint32_t *mat)
{
  for (int n = 0; n < 32; n++)
    square[n] = gf2_times(mat, mat[n]);
}

static uint32_t crc32_combine(uint32_t crc1, uint32_t crc2, uint64_t len2)
{
  uint32_t even[32], odd[32];
  if (len2 == 0)
    return crc1;
  odd[0] = 0xEDB88320u;
  uint32_t row = 1;
  for (int n = 1; n < 32; n++)
  {
    odd[n] = row;
    row <<= 1;
  }
  gf2_square(even, odd);
  gf2_square(odd, even);
  do
  {
    gf2_square(even, odd);
    if (len2 & 1)
      crc1 = gf2_times(even, crc1);
    len2 >>= 1;
    if (len2 == 0)
      break;
    gf2_square(odd, even);
    if (len2 & 1)
      crc1 = gf2_times(odd, crc1);
    len2 >>= 1;
  } while (len2 != 0);
  return crc1 ^ crc2;
}

// Running CRC-32: `seed` is the CRC of all preceding bytes (0 to start),
// so callers can chain across multiple buffers (checkpoint payloads).
uint32_t blio_crc32(const uint8_t *buf, uint64_t len, uint32_t seed)
{
  crc_init();
#if defined(_OPENMP)
  if (len >= (1u << 22))
  {
    int num_chunks = omp_get_max_threads();
    if (num_chunks > 16)
      num_chunks = 16;
    uint64_t chunk = len / static_cast<uint64_t>(num_chunks);
    uint32_t crcs[16];
    uint64_t lens[16];
    #pragma omp parallel for schedule(static)
    for (int i = 0; i < num_chunks; i++)
    {
      uint64_t begin = static_cast<uint64_t>(i) * chunk;
      uint64_t end = (i == num_chunks - 1) ? len : begin + chunk;
      crcs[i] = crc32_chunk(i == 0 ? seed : 0, buf + begin, end - begin);
      lens[i] = end - begin;
    }
    uint32_t crc = crcs[0];
    for (int i = 1; i < num_chunks; i++)
      crc = crc32_combine(crc, crcs[i], lens[i]);
    return crc;
  }
#endif
  return crc32_chunk(seed, buf, len);
}

// ---------------------------------------------------------------------------
// Snapshot repack kernels: the host-side transposes the reference performs
// cell-by-cell when ingesting dumps (simulation_reader.cpp:782-807 iharm3d,
// :828-841 harm3d, :555-580 AthenaK double data). Blocked loops + OpenMP.
// ---------------------------------------------------------------------------

// (n1, n2, n3, ncol) float32 table -> (nvar, n3, n2, n1) float32,
// selecting columns [col0, col0 + nvar). Used by iharm3d (col0=0) and
// harm3d (col0=6).
void blio_repack_table(const float *table, float *out, int64_t n1, int64_t n2,
                       int64_t n3, int64_t ncol, int64_t col0, int64_t nvar)
{
  const int64_t tile = 32;
  #pragma omp parallel for schedule(static) collapse(2)
  for (int64_t v = 0; v < nvar; v++)
    for (int64_t k = 0; k < n3; k++)
      for (int64_t j0 = 0; j0 < n2; j0 += tile)
        for (int64_t i0 = 0; i0 < n1; i0 += tile)
        {
          int64_t j1 = j0 + tile < n2 ? j0 + tile : n2;
          int64_t i1 = i0 + tile < n1 ? i0 + tile : n1;
          for (int64_t j = j0; j < j1; j++)
            for (int64_t i = i0; i < i1; i++)
              out[((v * n3 + k) * n2 + j) * n1 + i] =
                  table[((i * n2 + j) * n3 + k) * ncol + col0 + v];
        }
}

// Scale one variable slice in place: out[var] *= factor (eint -> pgas)
void blio_scale_slice(float *out, int64_t var, int64_t cells_per_var,
                      float factor)
{
  float *p = out + var * cells_per_var;
  #pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < cells_per_var; i++)
    p[i] *= factor;
}

// float64 -> float32 conversion (AthenaK double cell data,
// simulation_reader.cpp:555-580)
void blio_f64_to_f32(const double *in, float *out, int64_t n)
{
  #pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++)
    out[i] = static_cast<float>(in[i]);
}

}  // extern "C"
