/*
 * oracle_driver.c — flat-array C ABI shim over the reference codec.
 *
 * This file is ORIGINAL code for this repo. It links against the unmodified
 * reference sources (compiled straight out of /root/reference, which stays
 * read-only and is never vendored here) and exposes the reference's
 * ragged-pointer API (double** / int**) as flat row-major buffers that
 * ctypes/NumPy can call. Used only as a golden-parity oracle by the test
 * suite and benchmark baseline; nothing in the production codec path touches
 * this.
 *
 * Reference entry points exercised: dct_init/dct_forward/dct_inverse
 * (dct.c), quant_init/quantize/dequantize/calculate_block_variance
 * (quantization.c), block_to_zigzag/zigzag_to_block/run_length_encode/
 * run_length_decode/build_huffman_codes/get_encoded_size (entropy.c).
 */

#include <dct.h>
#include <quantization.h>
#include <entropy.h>
#include <stdlib.h>
#include <string.h>

/* ----- flat <-> ragged helpers (our own; the reference only has ragged) --- */

static double **to_ragged(const double *flat, int n) {
    double **a = alloc_array(n, n);
    for (int i = 0; i < n; ++i)
        memcpy(a[i], flat + (size_t)i * n, n * sizeof(double));
    return a;
}

static void from_ragged(double **a, double *flat, int n) {
    for (int i = 0; i < n; ++i)
        memcpy(flat + (size_t)i * n, a[i], n * sizeof(double));
}

static int **to_ragged_i(const int *flat, int n) {
    int **a = alloc_int_array(n, n);
    for (int i = 0; i < n; ++i)
        memcpy(a[i], flat + (size_t)i * n, n * sizeof(int));
    return a;
}

static void from_ragged_i(int **a, int *flat, int n) {
    for (int i = 0; i < n; ++i)
        memcpy(flat + (size_t)i * n, a[i], n * sizeof(int));
}

/* ----------------------------- transform -------------------------------- */

void oracle_dct_matrix(int n, double *out) {
    DCTContext *ctx = dct_init(n);
    from_ragged(ctx->dct_matrix, out, n);
    dct_free(ctx);
}

void oracle_dct_forward(int n, const double *in, double *out) {
    DCTContext *ctx = dct_init(n);
    double **a = to_ragged(in, n), **b = alloc_array(n, n);
    dct_forward(ctx, a, b);
    from_ragged(b, out, n);
    free_array(a, n); free_array(b, n); dct_free(ctx);
}

void oracle_dct_inverse(int n, const double *in, double *out) {
    DCTContext *ctx = dct_init(n);
    double **a = to_ragged(in, n), **b = alloc_array(n, n);
    dct_inverse(ctx, a, b);
    from_ragged(b, out, n);
    free_array(a, n); free_array(b, n); dct_free(ctx);
}

/* ---------------------------- quantization ------------------------------ */

void oracle_quant_matrix(int n, int quality, double *out) {
    double **m = generate_quant_matrix(n, quality);
    from_ragged(m, out, n);
    free_array(m, n);
}

double oracle_block_variance(int n, const double *block) {
    double **a = to_ragged(block, n);
    double v = calculate_block_variance(a, n);
    free_array(a, n);
    return v;
}

void oracle_quantize(int n, int quality, int adaptive, const double *coeffs,
                     double variance, int *out) {
    QuantContext *ctx = quant_init(n, quality, adaptive);
    double **c = to_ragged(coeffs, n);
    int **q = alloc_int_array(n, n);
    quantize(ctx, c, q, variance);
    from_ragged_i(q, out, n);
    free_array(c, n); free_int_array(q, n); quant_free(ctx);
}

void oracle_dequantize(int n, int quality, int adaptive, const int *qcoeffs,
                       double variance, double *out) {
    QuantContext *ctx = quant_init(n, quality, adaptive);
    int **q = to_ragged_i(qcoeffs, n);
    double **c = alloc_array(n, n);
    dequantize(ctx, q, c, variance);
    from_ragged(c, out, n);
    free_int_array(q, n); free_array(c, n); quant_free(ctx);
}

/* ------------------------------- entropy -------------------------------- */

void oracle_zigzag(int n, const int *block, int *zz) {
    int **b = to_ragged_i(block, n);
    block_to_zigzag(b, zz, n);
    free_int_array(b, n);
}

void oracle_inv_zigzag(int n, const int *zz, int *block) {
    int **b = alloc_int_array(n, n);
    /* block_to_zigzag's inverse wants a mutable zigzag buffer */
    int *tmp = (int *)malloc((size_t)n * n * sizeof(int));
    memcpy(tmp, zz, (size_t)n * n * sizeof(int));
    zigzag_to_block(tmp, b, n);
    from_ragged_i(b, block, n);
    free(tmp); free_int_array(b, n);
}

/* Returns symbol count; fills values/runs (caller provides n*n capacity). */
int oracle_rle_encode(int n, const int *qcoeffs, int *values, int *runs) {
    EntropyContext *ctx = entropy_init(0);
    int **q = to_ragged_i(qcoeffs, n);
    int count = run_length_encode(ctx, q, n);
    for (int i = 0; i < count; ++i) {
        values[i] = ctx->symbols[i].value;
        runs[i] = ctx->symbols[i].run_length;
    }
    free_int_array(q, n); entropy_free(ctx);
    return count;
}

void oracle_rle_decode(int n, const int *values, const int *runs, int count,
                       int *block_out) {
    EntropyContext *ctx = entropy_init(0);
    if (count > ctx->capacity) {
        ctx->capacity = count;
        ctx->symbols = (RLESymbol *)realloc(ctx->symbols,
                                            (size_t)count * sizeof(RLESymbol));
    }
    for (int i = 0; i < count; ++i) {
        ctx->symbols[i].value = values[i];
        ctx->symbols[i].run_length = runs[i];
    }
    ctx->count = count;
    int **q = alloc_int_array(n, n);
    run_length_decode(ctx, q, n);
    from_ragged_i(q, block_out, n);
    free_int_array(q, n); entropy_free(ctx);
}

/* Reference Huffman size estimate over an externally supplied symbol list. */
int oracle_encoded_size(const int *values, const int *runs, int count,
                        int use_huffman) {
    EntropyContext *ctx = entropy_init(use_huffman);
    if (count > ctx->capacity) {
        ctx->capacity = count;
        ctx->symbols = (RLESymbol *)realloc(ctx->symbols,
                                            (size_t)count * sizeof(RLESymbol));
    }
    for (int i = 0; i < count; ++i) {
        ctx->symbols[i].value = values[i];
        ctx->symbols[i].run_length = runs[i];
    }
    ctx->count = count;
    if (use_huffman) build_huffman_codes(ctx);
    int bits = get_encoded_size(ctx);
    entropy_free(ctx);
    return bits;
}

/* Batch driver for fair throughput baselines: runs the full reference
 * encode pipeline (level shift -> DCT -> variance -> quantize -> RLE ->
 * Huffman -> size estimate) over nblocks blocks in ONE call, reusing the
 * contexts the way a real C driver would, so ctypes per-call overhead does
 * not pollute the measurement. Returns the summed bit-size estimate. */
long long oracle_encode_batch(int n, int quality, int adaptive,
                              int use_huffman, const unsigned char *pixels,
                              int nblocks) {
    DCTContext *dctx = dct_init(n);
    QuantContext *qctx = quant_init(n, quality, adaptive);
    long long total_bits = 0;

    double **in = alloc_array(n, n);
    double **coeffs = alloc_array(n, n);
    int **qc = alloc_int_array(n, n);

    for (int b = 0; b < nblocks; ++b) {
        const unsigned char *p = pixels + (size_t)b * n * n;
        for (int i = 0; i < n; ++i)
            for (int j = 0; j < n; ++j)
                in[i][j] = (double)p[i * n + j] - 128.0;
        double variance = adaptive ? calculate_block_variance(in, n) : 0.0;
        dct_forward(dctx, in, coeffs);
        quantize(qctx, coeffs, qc, variance);
        EntropyContext *ectx = entropy_init(use_huffman);
        run_length_encode(ectx, qc, n);
        if (use_huffman) build_huffman_codes(ectx);
        total_bits += get_encoded_size(ectx);
        entropy_free(ectx);
    }

    free_array(in, n); free_array(coeffs, n); free_int_array(qc, n);
    dct_free(dctx); quant_free(qctx);
    return total_bits;
}

/* ------------------------- full block pipeline --------------------------- */

/*
 * Encode+decode one block of raw u8 pixels through the complete reference
 * pipeline (mirrors test_with_dct_coefficients, test_entropy.c:278-405).
 * Outputs: quantized zigzag coeffs (via RLE round-trip), reconstructed
 * pixels, bit-size estimate. Returns RLE symbol count.
 */
int oracle_block_pipeline(int n, int quality, int adaptive, int use_huffman,
                          const unsigned char *pixels, int *zz_out,
                          unsigned char *recon_out, int *bits_out) {
    DCTContext *dctx = dct_init(n);
    QuantContext *qctx = quant_init(n, quality, adaptive);
    EntropyContext *ectx = entropy_init(use_huffman);

    double **in = alloc_array(n, n);
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j)
            in[i][j] = (double)pixels[i * n + j] - 128.0;

    double variance = calculate_block_variance(in, n);

    double **coeffs = alloc_array(n, n);
    dct_forward(dctx, in, coeffs);

    int **qc = alloc_int_array(n, n);
    quantize(qctx, coeffs, qc, variance);

    int count = run_length_encode(ectx, qc, n);
    if (use_huffman) build_huffman_codes(ectx);
    *bits_out = get_encoded_size(ectx);

    /* decode mirror */
    int **qc2 = alloc_int_array(n, n);
    run_length_decode(ectx, qc2, n);

    int *zz = (int *)malloc((size_t)n * n * sizeof(int));
    block_to_zigzag(qc2, zz, n);
    memcpy(zz_out, zz, (size_t)n * n * sizeof(int));
    free(zz);

    double **deq = alloc_array(n, n);
    dequantize(qctx, qc2, deq, variance);

    double **rec = alloc_array(n, n);
    dct_inverse(dctx, deq, rec);

    for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) {
            double v = rec[i][j] + 128.0;
            if (v < 0.0) v = 0.0;
            if (v > 255.0) v = 255.0;
            recon_out[i * n + j] = (unsigned char)(v + 0.5);
        }

    free_array(in, n); free_array(coeffs, n); free_array(deq, n);
    free_array(rec, n);
    free_int_array(qc, n); free_int_array(qc2, n);
    dct_free(dctx); quant_free(qctx); entropy_free(ectx);
    return count;
}

/* ----------------------- decode-batch throughput ------------------------- */

/*
 * Time the reference's DECODE half over a batch: run_length_decode ->
 * dequantize -> dct_inverse -> +128/clamp (the mirror at
 * test_entropy.c:349-393). Phase 1 (untimed) produces each block's RLE
 * symbol list + variance via the encode pipeline; phase 2 (timed) decodes.
 * Returns the decode-phase wall seconds.
 */
#include <time.h>

double oracle_decode_batch_seconds(int n, int quality, int adaptive,
                                   const unsigned char *pixels, int nblocks) {
    DCTContext *dctx = dct_init(n);
    QuantContext *qctx = quant_init(n, quality, adaptive);

    /* phase 1: encode everything, keep per-block contexts alive */
    EntropyContext **ectxs =
        (EntropyContext **)malloc((size_t)nblocks * sizeof(EntropyContext *));
    double *variances = (double *)malloc((size_t)nblocks * sizeof(double));
    double **in = alloc_array(n, n);
    double **coeffs = alloc_array(n, n);
    int **qc = alloc_int_array(n, n);
    for (int b = 0; b < nblocks; ++b) {
        const unsigned char *p = pixels + (size_t)b * n * n;
        for (int i = 0; i < n; ++i)
            for (int j = 0; j < n; ++j)
                in[i][j] = (double)p[i * n + j] - 128.0;
        variances[b] = adaptive ? calculate_block_variance(in, n) : 0.0;
        dct_forward(dctx, in, coeffs);
        quantize(qctx, coeffs, qc, variances[b]);
        ectxs[b] = entropy_init(0);
        run_length_encode(ectxs[b], qc, n);
    }

    /* phase 2 (timed): the decode mirror */
    int **qc2 = alloc_int_array(n, n);
    double **deq = alloc_array(n, n);
    double **rec = alloc_array(n, n);
    volatile unsigned int sink = 0;
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (int b = 0; b < nblocks; ++b) {
        run_length_decode(ectxs[b], qc2, n);
        dequantize(qctx, qc2, deq, variances[b]);
        dct_inverse(dctx, deq, rec);
        for (int i = 0; i < n; ++i)
            for (int j = 0; j < n; ++j) {
                double v = rec[i][j] + 128.0;
                if (v < 0.0) v = 0.0;
                if (v > 255.0) v = 255.0;
                sink += (unsigned char)(v + 0.5);
            }
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    (void)sink;

    for (int b = 0; b < nblocks; ++b) entropy_free(ectxs[b]);
    free(ectxs); free(variances);
    free_array(in, n); free_array(coeffs, n); free_array(deq, n);
    free_array(rec, n);
    free_int_array(qc, n); free_int_array(qc2, n);
    dct_free(dctx); quant_free(qctx);
    return (double)(t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
}
