#!/usr/bin/env bash
#
# Ground-station RX entrypoint — operator-compatible with the reference's
# start_rx.sh / start_rx_headless.sh (same edit-the-header variables, same
# SDR tuning-offset formula, start_rx.sh:10-68,103-108), launching the
# single-process JAX pipeline instead of the 4-process shell chain.
#
#   rtl_sdr -> python -m wenet_tpu rx -   (demod+LDPC+router in one program)
#
# All variables can also be supplied as environment overrides (Docker tier).
set -euo pipefail

MYCALL="${MYCALL:-N0CALL}"              # your callsign (logging only here)
RXFREQ="${RXFREQ:-443500000}"           # centre frequency, Hz
GAIN="${GAIN:-0}"                       # rtl_sdr gain dB; 0 = AGC
BIAS="${BIAS:-0}"                       # 1 = enable bias tee (rtl_sdr -T)
BAUD_RATE="${BAUD_RATE:-115177}"        # 115177 (v1) or 96000 (v2)
OVERSAMPLING="${OVERSAMPLING:-8}"       # SDR rate = BAUD_RATE * OVERSAMPLING
FRAMING_MODE="${FRAMING_MODE:-}"        # v1|v2; default derives from baud
DEVICE="${DEVICE:-0}"                   # rtl_sdr device index
HEADLESS="${HEADLESS:-0}"               # 1 = no GUI side-channels
IMAGE_DIR="${IMAGE_DIR:-./rx_images}"
LOG_DIR="${LOG_DIR:-./rx_logs}"

SDR_RATE=$((BAUD_RATE * OVERSAMPLING))
# Tuning offset so the FSK tones land inside the estimator band
# (reference formula: Offset = Fc - Rs*(Os/4 - 0.25), start_rx.sh:103-108)
RX_SSB_FREQ=$(python3 - "$RXFREQ" "$BAUD_RATE" "$OVERSAMPLING" <<'EOF'
import sys
fc, rs, os_ = (int(float(x)) for x in sys.argv[1:4])
print(int(fc - rs * (os_ / 4.0 - 0.25)))
EOF
)

if [ -z "$FRAMING_MODE" ]; then
    if [ "$BAUD_RATE" -ge 100000 ]; then FRAMING_MODE=v1; else FRAMING_MODE=v2; fi
fi

RX_FLOW="${RX_FLOW:-IQ}"                # IQ | GQRX | SSB (start_rx.sh:118-150)

# plain strings, not arrays: bash 3.2 + `set -u` chokes on empty-array
# expansion even with the ${arr[@]+...} guard in some point releases; the
# values here are numeric flags with no spaces, so word splitting is safe.
# GAIN must therefore be a single numeric token (rtl_sdr takes one dB value)
case "$GAIN" in
    ''|*[!0-9.]*) echo "GAIN must be numeric (got '$GAIN')" >&2; exit 1 ;;
esac
GAIN_ARGS=""
if [ "$GAIN" != "0" ]; then GAIN_ARGS="-g $GAIN"; fi
if [ "$BIAS" = "1" ]; then GAIN_ARGS="$GAIN_ARGS -T"; fi

EXTRA=""
if [ "$HEADLESS" = "1" ]; then EXTRA="--headless"; fi

echo "$MYCALL: flow $RX_FLOW @ ${RX_SSB_FREQ} Hz, ${SDR_RATE} S/s," \
     "mode $FRAMING_MODE (baud $BAUD_RATE)" >&2

if [ "$RX_FLOW" = "GQRX" ]; then
    # GQRX mode: 48 kHz real s16 audio over UDP 7355 (start_rx.sh:128-137);
    # estimator limits match the reference's `fsk_demod -b 1 -u 23500`
    exec nc -l -u localhost 7355 | \
        python3 -m wenet_tpu rx - --format s16 --mode "$FRAMING_MODE" \
            --fs 48000 --rs "$BAUD_RATE" --est-min 1 --est-max 23500 \
            --image-dir "$IMAGE_DIR" --log-dir "$LOG_DIR" --partialupdate 4 \
            $EXTRA
elif [ "$RX_FLOW" = "SSB" ]; then
    # DC-spike tuners: receive below centre, USB-demodulate via csdr to
    # real s16 (start_rx.sh:138-149)
    exec rtl_sdr -d "$DEVICE" -s "$SDR_RATE" -f "$RX_SSB_FREQ" \
            $GAIN_ARGS - | \
        csdr convert_u8_f | csdr bandpass_fir_fft_cc 0.05 0.45 0.05 | \
        csdr realpart_cf | csdr gain_ff 0.5 | csdr convert_f_s16 | \
        python3 -m wenet_tpu rx - --format s16 --mode "$FRAMING_MODE" \
            --fs "$SDR_RATE" --rs "$BAUD_RATE" \
            --image-dir "$IMAGE_DIR" --log-dir "$LOG_DIR" --partialupdate 32 \
            $EXTRA
else
    exec rtl_sdr -d "$DEVICE" -s "$SDR_RATE" -f "$RX_SSB_FREQ" \
            $GAIN_ARGS - | \
        python3 -m wenet_tpu rx - --format cu8 --mode "$FRAMING_MODE" \
            --fs "$SDR_RATE" --rs "$BAUD_RATE" \
            --image-dir "$IMAGE_DIR" --log-dir "$LOG_DIR" --partialupdate 32 \
            $EXTRA
fi
