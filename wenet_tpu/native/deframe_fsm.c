/* Native UW-acquisition state machine + sample-format conversion.
 *
 * Host-side runtime of the receive chain: the acquisition gating is inherently
 * sequential (LOOK_FOR_UW / COLLECT_PACKET with a frozen bit buffer during
 * collection — reference semantics: src/wenet_ldpc.c:171-259,
 * src/drs232_ldpc.c:176-275), so it runs as one C pass over the soft-symbol
 * stream while the batched LDPC decode of the windows it finds runs on the
 * accelerator.  Mirrors wenet_tpu.ops.deframe.uw_detect_positions bit-exactly
 * (parity-tested); built as a shared library via ctypes.
 */
#include <stdint.h>
#include <string.h>

/* Sliding UW detector over hard decisions of `soft` (bit = soft < 0).
 * init_buf: nuw bytes of prior bit_buffer state (zeros at stream start).
 * Returns the number of detections written to out_pos (UW-end indices);
 * final_buf receives the bit_buffer content after the last detection.
 * A detection whose packet window [t+1, t+syms] does not fit is ignored
 * (matches the C deframer, which simply runs out of input). */
long uw_detect(const float *soft, long n, const uint8_t *uw, int nuw,
               int allowed, long syms, const int8_t *init_buf,
               int64_t *out_pos, long max_out, int8_t *final_buf)
{
    int8_t buf[64];
    int thresh = nuw - allowed;
    long ndet = 0;
    long t = 0;
    int i, score;

    memcpy(buf, init_buf, nuw);

    while (t < n) {
        /* shift in the next hard bit */
        memmove(buf, buf + 1, nuw - 1);
        buf[nuw - 1] = soft[t] < 0.0f;

        score = 0;
        for (i = 0; i < nuw; i++)
            score += (buf[i] == uw[i]);

        if (score >= thresh) {
            if (t + syms >= n)
                break;              /* packet cannot complete: stream ends */
            if (ndet < max_out)
                out_pos[ndet] = t;
            ndet++;
            memcpy(final_buf, buf, nuw);   /* buffer frozen during COLLECT */
            t += syms;                     /* skip collected symbols */
            memcpy(buf, final_buf, nuw);   /* resume with stale buffer */
        }
        t++;
    }
    if (ndet == 0)
        memcpy(final_buf, buf, nuw);
    return ndet;
}

/* cu8 interleaved IQ -> complex64 ((x-127)/128, fsk_demod.c:281-287) */
void cu8_to_c64(const uint8_t *raw, long n_samples, float *out)
{
    long i;
    for (i = 0; i < n_samples; i++) {
        out[2 * i] = ((float)raw[2 * i] - 127.0f) / 128.0f;
        out[2 * i + 1] = ((float)raw[2 * i + 1] - 127.0f) / 128.0f;
    }
}

/* cs16 interleaved IQ -> complex64 (/FDMDV_SCALE, fsk_demod.c:289-296) */
void cs16_to_c64(const int16_t *raw, long n_samples, float *out)
{
    const float scale = 1.0f / 825.0f;   /* FDMDV_SCALE */
    long i;
    for (i = 0; i < n_samples; i++) {
        out[2 * i] = (float)raw[2 * i] * scale;
        out[2 * i + 1] = (float)raw[2 * i + 1] * scale;
    }
}

/* Hard-decision pack: soft stream -> bits (for correlation paths) */
void soft_to_bits(const float *soft, long n, uint8_t *bits)
{
    long i;
    for (i = 0; i < n; i++)
        bits[i] = soft[i] < 0.0f;
}
