/* Native single-pass quantize+pack for the pair-K checkpoint layout (the
 * port's copy of the JAX package's csrc/qpack.c; a host quantizer for the
 * converter, not a device kernel).
 *
 * This is the converter's hot loop (convert/quantize.py drives it through
 * convert/native.py and ctypes): blockwise absmax -> nearest-codebook-entry
 * -> rank/nibble pack, bit-identical to the numpy golden
 * ops/format.pack_tpu_pairk[_lut] and to the torch path in
 * convert/quantize.py (tests/test_torch_convert.py).  One fused pass + a
 * cache-blocked transpose replaces the torch path's separate
 * abs/amax/div/bucketize/gather/transpose/shift passes, and never
 * materializes the (N, K) float `normed` temporary.
 *
 * Semantics pinned to ops/format.quantize_codes:
 *   - blocks run over flat row-major order, blocksize divides K (so blocks
 *     never straddle rows);
 *   - normalization is IEEE f32 DIVISION by the (safe) absmax, matching
 *     numpy/torch elementwise division bit-for-bit;
 *   - nearest entry = count of sorted-codebook midpoints strictly below x
 *     (tie at an exact midpoint picks the smaller value), then map through
 *     `map16` = RANK_REMAP[argsort(code)] ("exact") or argsort(code)
 *     (other variants / LUT codebooks);
 *   - bf16 scales: the stored scale is rounded FIRST (f32->bf16
 *     round-to-nearest-even, as torch rounds), and codes re-quantize
 *     against the rounded value (pack_tpu_pairk contract).
 *
 * Layout produced (pack_tpu_pairk docstring): packed uint8 (K/2, N) with
 * byte (i, n) = code(Wt[2i+1, n]) << 4 | code(Wt[2i, n]); scale f32
 * (K/blocksize, N) = absmax / value_scale.  The quantize pass writes both
 * row-major -- (N, K/2) and (N, K/bs), contiguous stores -- and a blocked
 * transpose produces the K-major outputs (direct stride-N stores touch one
 * cache line per byte).
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* f32 -> bf16 -> f32 with round-to-nearest-even (torch's rule).
 * absmax/192 is finite and >= 0, so no NaN handling is needed. */
static inline float bf16_rne(float v) {
    union { float f; uint32_t u; } a;
    a.f = v;
    a.u += 0x7FFFu + ((a.u >> 16) & 1u);
    a.u &= 0xFFFF0000u;
    return a.f;
}

#define MAX_BLOCK 4096 /* wrapper enforces blocksize <= this */

/* One quantization block: absmax -> (rounded) scale -> normalized midpoint
 * counts -> stored nibbles.  `bs` is a compile-time constant at the hot call
 * site (64) so every loop has a constant trip count and vectorizes. */
static inline void qblock(const float *restrict blk, int64_t bs,
                          const float *restrict mids15,
                          const uint8_t *restrict map16, int bf16_scale,
                          float value_scale, float *restrict scale_out,
                          uint8_t *restrict codes_out) {
    float xs[MAX_BLOCK];
    int32_t cnt[MAX_BLOCK];
    /* 4 independent accumulators break the maxss dependency chain (the
     * conditional-max reduction does not auto-vectorize under strict IEEE) */
    float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, m3 = 0.0f;
    int64_t i = 0;
    for (; i + 4 <= bs; i += 4) {
        float x0 = fabsf(blk[i]), x1 = fabsf(blk[i + 1]);
        float x2 = fabsf(blk[i + 2]), x3 = fabsf(blk[i + 3]);
        m0 = x0 > m0 ? x0 : m0;
        m1 = x1 > m1 ? x1 : m1;
        m2 = x2 > m2 ? x2 : m2;
        m3 = x3 > m3 ? x3 : m3;
    }
    for (; i < bs; i++) {
        float x = fabsf(blk[i]);
        m0 = x > m0 ? x : m0;
    }
    m0 = m1 > m0 ? m1 : m0;
    m2 = m3 > m2 ? m3 : m2;
    float am = m2 > m0 ? m2 : m0;
    if (bf16_scale) {
        float r = bf16_rne(am / value_scale);
        *scale_out = r;
        am = r * value_scale;
    } else {
        *scale_out = am / value_scale;
    }
    const float safe = (am == 0.0f) ? 1.0f : am;
    for (int64_t t = 0; t < bs; t++) {
        xs[t] = blk[t] / safe;
        cnt[t] = 0;
    }
    for (int j = 0; j < 15; j++) {
        const float m = mids15[j];
        for (int64_t t = 0; t < bs; t++)
            cnt[t] += xs[t] > m; /* strict: golden tie rule */
    }
    for (int64_t t = 0; t < bs; t++)
        codes_out[t] = map16[cnt[t]];
}

/* (rows, cols) -> (cols, rows), tiled so tile sources stay L1-resident and
 * every destination store run is contiguous. */
static void transpose_u8(const uint8_t *restrict src, int64_t rows,
                         int64_t cols, uint8_t *restrict dst) {
    const int64_t TB = 128;
    for (int64_t c0 = 0; c0 < cols; c0 += TB) {
        const int64_t c1 = c0 + TB < cols ? c0 + TB : cols;
        for (int64_t r0 = 0; r0 < rows; r0 += TB) {
            const int64_t r1 = r0 + TB < rows ? r0 + TB : rows;
            for (int64_t c = c0; c < c1; c++) {
                uint8_t *restrict d = dst + c * rows + r0;
                for (int64_t r = r0; r < r1; r++)
                    d[r - r0] = src[r * cols + c];
            }
        }
    }
}

static void transpose_f32(const float *restrict src, int64_t rows,
                          int64_t cols, float *restrict dst) {
    const int64_t TB = 64;
    for (int64_t c0 = 0; c0 < cols; c0 += TB) {
        const int64_t c1 = c0 + TB < cols ? c0 + TB : cols;
        for (int64_t r0 = 0; r0 < rows; r0 += TB) {
            const int64_t r1 = r0 + TB < rows ? r0 + TB : rows;
            for (int64_t c = c0; c < c1; c++) {
                float *restrict d = dst + c * rows + r0;
                for (int64_t r = r0; r < r1; r++)
                    d[r - r0] = src[r * cols + c];
            }
        }
    }
}

/* w:        (n_out, k_in) f32, row-major (C-contiguous)
 * mids15:   the 15 sorted-codebook midpoints, f32 (computed in numpy so the
 *           (a+b)/2 rounding matches the golden exactly)
 * map16:    sorted-position -> stored nibble (16 entries)
 * bf16_scale: nonzero = round the stored scale to bf16 first (see above)
 * value_scale: 192.0 for FP4-family pair-K variants, 1.0 for LUT codebooks
 * packed:   out, uint8 (k_in/2, n_out) C-contiguous
 * scale:    out, f32 (k_in/blocksize, n_out) C-contiguous (for bf16_scale the
 *           values are already bf16-representable; caller casts losslessly)
 * returns 0 on success, -1 on allocation failure.
 */
int qpack_pairk(const float *w, int64_t n_out, int64_t k_in, int64_t blocksize,
                const float *mids15, const uint8_t *map16, int bf16_scale,
                float value_scale, uint8_t *packed, float *scale) {
    const int64_t nblocks = k_in / blocksize;
    const int64_t kp = k_in / 2;
    uint8_t *tpacked = malloc((size_t)(n_out * kp));
    float *tscale = malloc((size_t)(n_out * nblocks) * sizeof(float));
    if (!tpacked || !tscale) {
        free(tpacked);
        free(tscale);
        return -1;
    }
    uint8_t codes[2 * MAX_BLOCK]; /* one PAIR of blocks, packed per pair */

    for (int64_t n = 0; n < n_out; n++) {
        const float *row = w + n * k_in;
        uint8_t *prow = tpacked + n * kp;
        float *srow = tscale + n * nblocks;
        for (int64_t b = 0; b < nblocks; b++) {
            const float *blk = row + b * blocksize;
            uint8_t *cb = codes + (b & 1) * blocksize;
            if (blocksize == 64) /* constant-trip clone: vectorizes */
                qblock(blk, 64, mids15, map16, bf16_scale, value_scale,
                       &srow[b], cb);
            else
                qblock(blk, blocksize, mids15, map16, bf16_scale, value_scale,
                       &srow[b], cb);
            if (b & 1) { /* flush the completed pair of blocks to bytes */
                uint8_t *dst = prow + (b - 1) * blocksize / 2;
                for (int64_t t = 0; t < blocksize; t++)
                    dst[t] = (uint8_t)(codes[2 * t] | (codes[2 * t + 1] << 4));
            }
        }
        /* k_in % (2*blocksize) == 0 (wrapper-checked), so pairs of blocks
         * always complete and everything is flushed. */
    }
    transpose_u8(tpacked, n_out, kp, packed);
    transpose_f32(tscale, n_out, nblocks, scale);
    free(tpacked);
    free(tscale);
    return 0;
}

/* Version probe so the ctypes loader can reject a stale cached build. */
int64_t qpack_abi_version(void) { return 2; }
