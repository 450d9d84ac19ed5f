/* Single-core CPU baseline: GF(2^8) erasure encode.
 *
 * Purpose: an honest CPU yardstick beside the card's kernel, and the codecs'
 * "native" runtime.  The encode uses the split-nibble table algorithm that
 * ISA-L / jerasure's SIMD paths use (reference semantics:
 * src/erasure-code/isa/ErasureCodeIsa.cc:118-130 ec_encode_data), expressed
 * with GCC vector extensions so -O3 -march=native lowers the 16-entry table
 * lookups to pshufb/vpshufb.  This is the encode half of the JAX package's
 * baseline (ceph_tpu/native/baseline.c), unchanged.
 *
 * Single-threaded by design: the baseline is "one CPU core".
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* GF(2^8), polynomial 0x11d (the ISA-L / jerasure w=8 field)          */
/* ------------------------------------------------------------------ */

static uint8_t gf_mul_tab[256][256];
static int gf_ready = 0;

static void gf_init(void) {
    if (gf_ready) return;
    uint8_t exp[512];
    int log[256];
    int x = 1;
    for (int i = 0; i < 255; i++) {
        exp[i] = (uint8_t)x;
        log[x] = i;
        x <<= 1;
        if (x & 0x100) x ^= 0x11d;
    }
    for (int i = 255; i < 510; i++) exp[i] = exp[i - 255];
    log[0] = -1;
    for (int a = 0; a < 256; a++)
        for (int b = 0; b < 256; b++)
            gf_mul_tab[a][b] = (a && b) ? exp[log[a] + log[b]] : 0;
    gf_ready = 1;
}

typedef uint8_t v32 __attribute__((vector_size(32)));

/* Encode: parity[s][i][:] = xor_j mul(matrix[i][j], data[s][j][:]).
 * Layout: data (stripes, k, chunk) C-contiguous; parity (stripes, m, chunk).
 * Per 32-byte block the data vector is loaded once and folded into all m
 * accumulators (the ISA-L dataflow: read data once, write parity once). */
void ec_encode_c(const uint8_t *matrix, int k, int m,
                 const uint8_t *data, uint8_t *parity,
                 long stripes, long chunk) {
    gf_init();
    if (m > 32) return; /* bench configs are far below this */
    /* per (i, j): 32-byte lo/hi nibble product tables (16 entries, doubled
     * across both 128-bit lanes so vpshufb sees the table in each lane) */
    /* vector loads are aligned moves; malloc only guarantees 16 bytes */
    v32 *lo = aligned_alloc(32, (size_t)m * k * sizeof(v32));
    v32 *hi = aligned_alloc(32, (size_t)m * k * sizeof(v32));
    for (int i = 0; i < m; i++)
        for (int j = 0; j < k; j++) {
            uint8_t c = matrix[i * k + j];
            uint8_t tl[32], th[32];
            for (int n = 0; n < 16; n++) {
                tl[n] = gf_mul_tab[c][n];
                tl[n + 16] = tl[n];
                th[n] = gf_mul_tab[c][n << 4];
                th[n + 16] = th[n];
            }
            memcpy(&lo[i * k + j], tl, 32);
            memcpy(&hi[i * k + j], th, 32);
        }
    const v32 mask15 = {15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
                        15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15};
    long vchunk = chunk & ~31L;
    for (long s = 0; s < stripes; s++) {
        const uint8_t *dbase = data + s * k * chunk;
        uint8_t *pbase = parity + s * m * chunk;
        for (long off = 0; off < vchunk; off += 32) {
            v32 acc[32];
            for (int i = 0; i < m; i++) acc[i] = (v32){0};
            for (int j = 0; j < k; j++) {
                v32 d;
                memcpy(&d, dbase + j * chunk + off, 32);
                v32 dl = d & mask15;
                v32 dh = (d >> 4) & mask15;
                for (int i = 0; i < m; i++)
                    acc[i] ^= __builtin_shuffle(lo[i * k + j], dl)
                            ^ __builtin_shuffle(hi[i * k + j], dh);
            }
            for (int i = 0; i < m; i++)
                memcpy(pbase + i * chunk + off, &acc[i], 32);
        }
        for (long off = vchunk; off < chunk; off++) {  /* scalar tail */
            for (int i = 0; i < m; i++) {
                uint8_t a = 0;
                for (int j = 0; j < k; j++)
                    a ^= gf_mul_tab[matrix[i * k + j]][dbase[j * chunk + off]];
                pbase[i * chunk + off] = a;
            }
        }
    }
    free(lo);
    free(hi);
}
