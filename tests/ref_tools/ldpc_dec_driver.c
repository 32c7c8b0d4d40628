/* Test-only oracle driver: wraps the reference run_ldpc_decoder so the JAX
 * decoder can be compared against the C sum-product implementation.
 *
 * Build (see tests/refbins.py):
 *   gcc -O2 -o ldpc_dec_driver ldpc_dec_driver.c \
 *       /root/reference/src/mpdecode_core.c /root/reference/src/phi0.c \
 *       -I/root/reference/src -lm
 *
 * Protocol: reads blocks of 2580 float32 LLRs from stdin; for each block
 * writes 2580 uint8 decoded bits, then int32 iter, then int32 parityCheckCount.
 */
#include <stdio.h>
#include <stdint.h>
#include "mpdecode_core.h"
#include "H2064_516_sparse.h"

int main(void) {
    struct LDPC ldpc;
    ldpc.max_iter = MAX_ITER;
    ldpc.dec_type = 0;
    ldpc.q_scale_factor = 1;
    ldpc.r_scale_factor = 1;
    ldpc.CodeLength = CODELENGTH;
    ldpc.NumberParityBits = NUMBERPARITYBITS;
    ldpc.NumberRowsHcols = NUMBERROWSHCOLS;
    ldpc.max_row_weight = MAX_ROW_WEIGHT;
    ldpc.max_col_weight = MAX_COL_WEIGHT;
    ldpc.H_rows = H_rows;
    ldpc.H_cols = H_cols;

    float llr[CODELENGTH];
    uint8_t out[CODELENGTH];
    while (fread(llr, sizeof(float), CODELENGTH, stdin) == CODELENGTH) {
        int parityCheckCount = 0;
        int32_t iter = run_ldpc_decoder(&ldpc, out, llr, &parityCheckCount);
        int32_t pcc = parityCheckCount;
        fwrite(out, 1, CODELENGTH, stdout);
        fwrite(&iter, sizeof(int32_t), 1, stdout);
        fwrite(&pcc, sizeof(int32_t), 1, stdout);
        fflush(stdout);
    }
    return 0;
}
