/* lilac native runtime: host-side hot loops that are inherently
 * sequential (RNG-stream-consuming generators) or parsing-bound, kept in C
 * the way the reference keeps its loaders/generators native
 * (/root/reference/parboil/.../mmio.c, convert_dataset.c,
 * /root/reference/SparseBench/SRC/reference/gen_crs.f). Exposed through
 * ctypes (lilac/native/__init__.py); everything returns into
 * caller-allocated numpy buffers.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

/* ---------------- NPB randlc (2^46 LCG, common/randi8.f) -------------- */

#define NPB_A 1220703125ull
#define MASK46 ((1ull << 46) - 1)

/* Phase-1 of makea (cg.f:707-720): per-row sparse random vectors via
 * rejection sampling. Returns total number of stored (pos, val) pairs.
 * nzv[na], pos[na*(nonzer+1)] (1-based), val[same]. */
long npb_triples(long na, int nonzer, int32_t* nzv, int64_t* pos, double* val) {
  uint64_t x = 314159265ull; /* tran, cg.f:186 */
  x = (x * NPB_A) & MASK46;  /* zeta = randlc(...) consumed once, cg.f:188 */
  long nn1 = 1;
  while (nn1 < na) nn1 *= 2;
  int shift_bits = 46 - (int)(log2((double)nn1) + 0.5);
  long w = 0;
  long* row_pos = (long*)malloc(sizeof(long) * (nonzer + 1));
  double* row_val = (double*)malloc(sizeof(double) * (nonzer + 1));
  for (long iouter = 1; iouter <= na; iouter++) {
    int cnt = 0;
    while (cnt < nonzer) {
      x = (x * NPB_A) & MASK46;
      double vecelt = (double)x * 0x1p-46;
      x = (x * NPB_A) & MASK46;
      long i = (long)(x >> shift_bits) + 1;
      if (i > na) continue;
      int dup = 0;
      for (int k = 0; k < cnt; k++)
        if (row_pos[k] == i) { dup = 1; break; }
      if (dup) continue;
      row_pos[cnt] = i;
      row_val[cnt] = vecelt;
      cnt++;
    }
    /* vecset (cg.f:718): force position iouter with value 0.5 */
    int found = -1;
    for (int k = 0; k < cnt; k++)
      if (row_pos[k] == iouter) { found = k; break; }
    if (found >= 0) {
      row_val[found] = 0.5;
    } else {
      row_pos[cnt] = iouter;
      row_val[cnt] = 0.5;
      cnt++;
    }
    nzv[iouter - 1] = cnt;
    for (int k = 0; k < cnt; k++) {
      pos[w] = row_pos[k];
      val[w] = row_val[k];
      w++;
    }
  }
  free(row_pos);
  free(row_val);
  return w;
}

/* ------------- SparseBench gen_crs fill loop (gen_crs.f:240-460) ------- */

#define DLARAN_A 33952834046453ull
#define MASK48 ((1ull << 48) - 1)

static uint64_t sb_x;
static double sb_rand(void) {
  sb_x = (sb_x * DLARAN_A) & MASK48;
  return (double)sb_x * 0x1p-48;
}

static long sb_top;
static long sb_cap;
static int sb_overflow;
static int64_t *sb_rows, *sb_cols;
static double *sb_vals, *sb_diag;
static int sb_sym;

static void fill_elt(long block_i, long i, long j) {
  double rval = 2.0 * sb_rand() - 1.0;
  /* keep consuming the DLARAN stream on overflow (state must stay exact
   * for the caller's own fallback decision), but never write past cap */
  if (sb_top + (sb_sym ? 1 : 2) > sb_cap) { sb_overflow = 1; }
  if (!sb_overflow) {
    sb_rows[sb_top] = i; sb_cols[sb_top] = j; sb_vals[sb_top] = rval; sb_top++;
    if (!sb_sym) {
      sb_rows[sb_top] = j; sb_cols[sb_top] = i; sb_vals[sb_top] = rval; sb_top++;
    }
  }
  if (i != j) {
    if (block_i == 0) rval = 1.1 * rval;
    sb_diag[i - 1] += fabs(rval);
    sb_diag[j - 1] += fabs(rval);
  }
}

static long ceil_ref(double v) {
  if (v == (double)(long)v) return (long)v;
  return (long)v + 1;
}

/* splits: [nblocks, 4] (s1, s2, s3, direction); returns #entries written,
 * or -1 if more than `cap` entries would be produced (nothing past cap is
 * written; caller should retry with a larger buffer or fall back).
 * diag[n] accumulates. Consumes the DLARAN stream from the given state;
 * returns new state via out_state. */
long sb_fill_matrix(const int64_t* splits, long nblocks, long n, int sym,
                    uint64_t state_in, uint64_t* state_out, long cap,
                    int64_t* rows, int64_t* cols, double* vals, double* diag) {
  sb_x = state_in;
  sb_top = 0;
  sb_cap = cap;
  sb_overflow = 0;
  sb_rows = rows; sb_cols = cols; sb_vals = vals; sb_diag = diag; sb_sym = sym;
  const double decay = 0.1, cutoff = 0.8, d = 3.0;
  const double inv_cut = 1.0 / cutoff;
  for (long i = 0; i < n; i++) diag[i] = sb_rand() / (double)n;
  for (long bi = 0; bi < nblocks; bi++) {
    long s1 = splits[4 * bi], s2 = splits[4 * bi + 1], s3 = splits[4 * bi + 2];
    long direction = splits[4 * bi + 3];
    long i1 = s1, i2 = s2 - 1, j1 = s2, j2 = s3;
    if (i1 == i2 || j1 == j2) {
      for (long i = i1; i <= i2; i++)
        for (long j = j1; j <= j2; j++) fill_elt(bi, i, j);
      continue;
    }
    long hinv_i = (long)(1.0 + pow((double)(i2 - i1) + 1.001, 1.0 / d));
    double allow_i = pow((double)hinv_i, d - 1.0);
    long hinv_j = (long)(1.0 + pow((double)(j2 - j1) + 1.001, 1.0 / d));
    double allow_j = pow((double)hinv_j, d - 1.0);
    double bd1 = (double)(i2 - i1 + 1) - allow_i;
    double bd2 = (double)(j2 - j1 + 1) - allow_j;
    long bdry = (long)(bd1 < bd2 ? bd1 : bd2);
    if (direction == 1) {
      for (long i = i1; i <= i2; i++) {
        double md;
        long aim = (i - i1) - bdry;
        if (aim >= 0 && j1 + aim <= j2) md = 1.0;
        else if (aim < 0) md = pow((double)(-aim) * 0.5 + 1.0, decay);
        else md = pow((double)(j1 + aim - j2) * 0.5 + 1.0, decay);
        if (md > inv_cut) continue;
        for (long j = j1; j <= j2; j++) {
          double damp = pow(fabs((double)((j - j1) - (i - i1) + bdry)) * 0.5 + 1.0, decay);
          double rval = sb_rand();
          if (rval / damp > cutoff) fill_elt(bi, i, j);
        }
      }
    } else {
      long cl = (i2 - i1) / hinv_i;
      if (cl < 1) cl = 1;
      for (long ic = i1; ic <= i2; ic += cl) {
        for (long jc = j1; jc <= j2; jc += cl) {
          double md = pow((double)ceil_ref(labs(ic - i1 - jc + j1) / (1.0 * hinv_i)) + 1.0, decay);
          if (md > inv_cut) continue;
          long imax = ic + cl - 1 < i2 ? ic + cl - 1 : i2;
          long jmax = jc + cl - 1 < j2 ? jc + cl - 1 : j2;
          for (long i = ic; i <= imax; i++) {
            for (long j = jc; j <= jmax; j++) {
              long il = (i - i1) % hinv_i;
              long jl = (j - j1) % hinv_i;
              double damp = pow((double)(hinv_i - 1 - il + jl +
                                ceil_ref(labs(i - i1 - j + j1) / (1.0 * hinv_i))) + 1.0, decay);
              double rval = sb_rand();
              if (rval / damp > cutoff) fill_elt(bi, i, j);
            }
          }
        }
      }
    }
  }
  *state_out = sb_x;
  return sb_overflow ? -1 : sb_top;
}

/* --------------- MatrixMarket coordinate fast parser ------------------ */

/* Parses the numeric body of an .mtx coordinate file (after the header and
 * size line). pattern: 2 ints/line; real: 2 ints + 1 double. Returns the
 * number of entries parsed or -1 on error. */
long mm_parse_body(const char* path, long skip_lines, long nnz, int pattern,
                   int64_t* rows, int64_t* cols, double* vals) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  char buf[512];
  for (long i = 0; i < skip_lines; i++)
    if (!fgets(buf, sizeof buf, f)) { fclose(f); return -1; }
  long k = 0;
  if (pattern) {
    long r, c;
    while (k < nnz && fscanf(f, "%ld %ld", &r, &c) == 2) {
      rows[k] = r; cols[k] = c; vals[k] = 1.0; k++;
    }
  } else {
    long r, c; double v;
    while (k < nnz && fscanf(f, "%ld %ld %lf", &r, &c, &v) == 3) {
      rows[k] = r; cols[k] = c; vals[k] = v; k++;
    }
  }
  fclose(f);
  return k;
}
