"""2/4-FSK modem (JAX).

Functional re-design of the reference C modem (src/fsk.c, src/fsk_demod.c):
same estimator/timing/decision *semantics* — Hann-windowed FFT tone
estimation with a slow EMA, per-tone downconvert + integrate-and-dump at P
phases, timing-tone phase extraction, elastic nin, soft bits = |t0|-|t1| —
but expressed as pure, batched array programs:

  * the modulator uses an exact integer phase accumulator (no float drift,
    fully parallel) instead of a spun complex oscillator (fsk.c:1118-1204)
  * the per-frame hot loop (fsk.c:766-842's sample-at-a-time downconvert and
    circular-buffer integrate) becomes complex-exp + cumsum window sums
  * the stream state machine (fsk_demod.c:270's fread(nin) loop with the
    samp_old stash, fsk.c:187-199/851) becomes a `lax.scan` whose carry is
    exactly the reference's FSK struct state: fft_est EMA, f_est latch,
    carrier phases, norm_rx_timing, ppm, nin, and a read pointer replacing
    the stash

Config reference: fsk_create_hbr (fsk.c:128-259) — Nsym=48 symbols/frame,
Ndft = highest power of two <= N, est_min=Rs/4, est_max=Fs/2-Rs/4,
est_space=Rs-Rs/5.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import compat

TWO_PI = 2.0 * np.pi


# ------------------------------------------------------------------- config


@dataclasses.dataclass(frozen=True)
class FSKConfig:
    """Static modem geometry (mirror of fsk_create_hbr, fsk.c:128-180)."""

    Fs: int
    Rs: int
    M: int = 2
    P: int | None = None          # defaults to Ts (fsk_demod.c:187)
    Nsym: int = 48
    est_min: int | None = None    # estimator band, Hz
    est_max: int | None = None

    def __post_init__(self):
        if self.Fs % self.Rs:
            raise ValueError("Fs must be an integer multiple of Rs")
        P = self.Ts if self.P is None else self.P
        object.__setattr__(self, "P", P)
        if self.Ts % P:
            raise ValueError("Ts must be an integer multiple of P")
        if self.M not in (2, 4):
            raise ValueError("M must be 2 or 4")
        object.__setattr__(
            self, "est_min", self.Rs // 4 if self.est_min is None else self.est_min)
        object.__setattr__(
            self, "est_max",
            self.Fs // 2 - self.Rs // 4 if self.est_max is None else self.est_max)

    # --- derived geometry ---
    @property
    def Ts(self) -> int:
        return self.Fs // self.Rs

    @property
    def N(self) -> int:
        return self.Ts * self.Nsym

    @property
    def Nmem(self) -> int:
        return self.N + 2 * self.Ts

    @property
    def nstash(self) -> int:
        return 4 * self.Ts

    @property
    def Ndft(self) -> int:
        return 1 << (self.N.bit_length() - 1)   # highest power of 2 <= N

    @property
    def est_space(self) -> int:
        return self.Rs - self.Rs // 5

    @property
    def Nbits(self) -> int:
        return self.Nsym if self.M == 2 else 2 * self.Nsym

    # estimator bins (integer math as in fsk_demod_freq_est, fsk.c:568-570)
    @property
    def f_min_bin(self) -> int:
        return (self.est_min * self.Ndft) // self.Fs

    @property
    def f_max_bin(self) -> int:
        return (self.est_max * self.Ndft) // self.Fs

    @property
    def f_zero_bins(self) -> int:
        return (self.est_space * self.Ndft) // self.Fs

    @property
    def ema_tc(self) -> float:
        return 0.95 * self.Ndft / self.Fs       # fsk.c:573

    @property
    def max_fft_blocks(self) -> int:
        return max(1, (self.N + self.Ts // 2) // self.Ndft)

    @property
    def nin_choices(self):
        return (self.N - self.Ts // 2, self.N, self.N + self.Ts // 2)

    def num_frames(self, n_samples: int) -> int:
        """Static upper bound on demod frames for a capture."""
        return n_samples // (self.N - self.Ts // 2) + 1


# v1/v2 standard configs (start_rx.sh:31-42, SURVEY.md appendix)
V1_CONFIG = FSKConfig(Fs=921416, Rs=115177)    # Ts=P=8
V2_CONFIG = FSKConfig(Fs=960000, Rs=96000)     # Ts=P=10


def hann_window(Ndft: int) -> np.ndarray:
    """0.5 - 0.5*cos(2 pi i/(Ndft-1)) — the table of fsk.c:94-111."""
    i = np.arange(Ndft, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(TWO_PI * i / (Ndft - 1))).astype(np.float32)


def default_frames_per_step(value=None) -> int:
    """Demod frames per scan step (demod_stream frames_per_step): bit-exact
    for any value; amortizes the per-step window gather F-fold.  Default
    16; WENET_FUSED_FSTEP for experiments.  Lives here (not rx.pipeline)
    so ops/parallel users don't import upward."""
    if value is not None:
        return int(value)
    import os
    return int(os.environ.get("WENET_FUSED_FSTEP", "16"))


def argmax_first(x):
    """(max value, FIRST index attaining it) along the last axis, as ONE
    variadic lax.reduce — identical semantics to jnp.max + min-of-where
    (the comparator is pure compares/selects, associative and commutative,
    so any reduction order is bit-identical) at half the reduction-op
    count of a max followed by an argmax."""
    n = x.shape[-1]
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), x.shape)

    def red(a, b):
        av, ai = a
        bv, bi = b
        tb = (bv > av) | ((bv == av) & (bi < ai))
        return jnp.where(tb, bv, av), jnp.where(tb, bi, ai)

    return jax.lax.reduce((x, idx), (jnp.float32(-jnp.inf), jnp.int32(n)),
                          red, (x.ndim - 1,))


# ---------------------------------------------------------------- modulator


def _sym_freqs(cfg: FSKConfig, f1: int, shift: int) -> np.ndarray:
    return np.array([f1 + shift * m for m in range(cfg.M)], dtype=np.int64)


def bits_to_symbols(bits: np.ndarray, M: int) -> np.ndarray:
    """MSB-first bit packing into M-ary symbols (fsk.c:1135-1143)."""
    bits = np.asarray(bits)
    if M == 2:
        return bits.astype(np.int64)
    return (bits.reshape(*bits.shape[:-1], -1, 2) * np.array([2, 1])).sum(-1)


def fsk_mod_np(cfg: FSKConfig, bits: np.ndarray, f1: int, shift: int,
               complex_out: bool = True, phase_acc: int = 0):
    """Continuous-phase FSK, exact integer phase accumulator (host/numpy).

    Same waveform as fsk_mod_c (fsk.c:1162-1204) without its float32
    oscillator drift: phase(t) = 2*pi*(sum of per-sample tone freqs mod Fs)/Fs.
    Returns (samples, final_phase_acc) so long streams can be chunked.
    """
    syms = bits_to_symbols(bits, cfg.M)
    freqs = _sym_freqs(cfg, f1, shift)[syms]                 # (nsym,) int64
    # per-symbol phase advance, and exact accumulator at each symbol start
    sym_adv = (freqs * cfg.Ts) % cfg.Fs
    start = (phase_acc + np.concatenate([[0], np.cumsum(sym_adv)[:-1]])) % cfg.Fs
    j = np.arange(1, cfg.Ts + 1, dtype=np.int64)             # C spins before output
    acc = (start[:, None] + freqs[:, None] * j[None, :]) % cfg.Fs
    theta = (TWO_PI / cfg.Fs) * acc.astype(np.float64)
    out = 2.0 * np.exp(1j * theta) if complex_out else 2.0 * np.cos(theta)
    final = int((phase_acc + int(np.sum(sym_adv))) % cfg.Fs)
    return out.reshape(-1).astype(np.complex64 if complex_out else np.float32), final


def fsk_mod_ext_vco(cfg: FSKConfig, bits: np.ndarray, f1: int,
                    shift: int) -> np.ndarray:
    """Per-sample VCO drive voltage (= instantaneous tone frequency in Hz),
    for an external-VCO transmitter: fsk_mod_ext_vco (fsk.c:1207-1243)."""
    syms = bits_to_symbols(np.asarray(bits), cfg.M)
    freqs = _sym_freqs(cfg, f1, shift)[syms].astype(np.float32)
    return np.repeat(freqs, cfg.Ts)


def _wrapped_cumsum(x: jnp.ndarray, mod: int, group: int = 512) -> jnp.ndarray:
    """Exclusive cumsum of int32 x modulo `mod`, overflow-safe via two-level
    grouping (int32 throughout, no int64)."""
    n = x.shape[-1]
    pad = (-n) % group
    xg = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)]).reshape(
        *x.shape[:-1], -1, group)
    within = jnp.cumsum(xg, axis=-1) % mod                    # <= group*mod

    def shift1(a):  # exclusive shift along the last axis: a zero column,
        # then all but the last element
        z = jnp.zeros_like(a[..., :1])
        return jnp.concatenate([z, a[..., :-1]], axis=-1)

    totals = within[..., -1]
    starts = shift1(jnp.cumsum(totals, axis=-1) % mod)
    excl = (shift1(within) + starts[..., None]) % mod
    return excl.reshape(*x.shape[:-1], -1)[..., :n]


@partial(jax.jit, static_argnames=("cfg", "f1", "shift"))
def fsk_mod(cfg: FSKConfig, bits: jnp.ndarray, f1: int, shift: int) -> jnp.ndarray:
    """Device modulator: bits (..., nbits) -> complex64 (..., nsym*Ts).

    Exact integer phase accumulator (see fsk_mod_np); safe for up to ~500k
    symbols per call (two-level int32 wrap).
    """
    freqs_tab = jnp.asarray(_sym_freqs(cfg, f1, shift).astype(np.int32))
    if cfg.M == 2:
        syms = bits.astype(jnp.int32)
    else:
        syms = bits.reshape(*bits.shape[:-1], -1, 2) @ jnp.array([2, 1], jnp.int32)
    freqs = freqs_tab[syms]                                   # (..., nsym)
    sym_adv = (freqs * cfg.Ts) % cfg.Fs
    start = _wrapped_cumsum(sym_adv, cfg.Fs)                  # (..., nsym)
    j = jnp.arange(1, cfg.Ts + 1, dtype=jnp.int32)
    acc = (start[..., None] + freqs[..., None] * j) % cfg.Fs  # (..., nsym, Ts)
    theta = acc.astype(jnp.float32) * np.float32(TWO_PI / cfg.Fs)
    out = 2.0 * jax.lax.complex(jnp.cos(theta), jnp.sin(theta))
    return out.reshape(*bits.shape[:-1], -1)


# ------------------------------------------------------------- demod state


class DemodState(NamedTuple):
    """Scan carry == the reference FSK struct's mutable fields (fsk.h:63-88)."""
    pos: jnp.ndarray              # int32 next-new-sample index (replaces samp_old)
    nin: jnp.ndarray              # int32 samples consumed this frame
    fft_est: jnp.ndarray          # (Ndft/2,) f32 EMA of tone spectrum
    f_est: jnp.ndarray            # (M,) f32 latched tone estimates
    phi: jnp.ndarray              # (M,) f32 carrier phase angles (rad, wrapped)
    norm_rx_timing: jnp.ndarray   # f32
    ppm: jnp.ndarray              # f32 clock-offset estimate
    ebno_db: jnp.ndarray          # f32
    snr_est: jnp.ndarray          # f32 smoothed stat (modem_stats)


def demod_init(cfg: FSKConfig) -> DemodState:
    f0 = jnp.float32(0)
    return DemodState(
        pos=jnp.int32(0), nin=jnp.int32(cfg.N),
        fft_est=jnp.zeros(cfg.Ndft // 2, jnp.float32),
        f_est=jnp.zeros(cfg.M, jnp.float32), phi=jnp.zeros(cfg.M, jnp.float32),
        norm_rx_timing=f0, ppm=f0, ebno_db=f0, snr_est=f0)


class FrameOut(NamedTuple):
    soft: jnp.ndarray             # (Nbits,) f32 soft decisions (|t0|-|t1|)
    bits: jnp.ndarray             # (Nbits,) uint8 hard decisions
    valid: jnp.ndarray            # bool — frame fully inside the capture
    f_est: jnp.ndarray            # (M,) f32
    ebno_db: jnp.ndarray          # f32
    norm_rx_timing: jnp.ndarray   # f32
    ppm: jnp.ndarray              # f32
    nin: jnp.ndarray              # int32 (nin used for this frame)


# ------------------------------------------------------------ per-frame core


def _freq_est_step(cfg: FSKConfig, fft_est, new_samps, nin, hann):
    """One frame of fsk_demod_freq_est (fsk.c:540-677): per-Ndft-block
    Hann window -> FFT -> band-masked |.| -> EMA; then M peak picks with
    +/-f_zero blanking on a copy of the EMA; ascending sort; bin -> Hz.

    new_samps: (max_fft_blocks*Ndft,) complex64 — the first samples of this
    frame's fresh input (zero-padded past nin by the caller's gather).
    """
    Ndft, half = cfg.Ndft, cfg.Ndft // 2
    tc = jnp.float32(cfg.ema_tc)
    idx = jnp.arange(Ndft)
    n_blocks = nin // Ndft                       # fft_loops (fsk.c:577)

    blocks = new_samps.reshape(cfg.max_fft_blocks, Ndft)
    for j in range(cfg.max_fft_blocks):
        # quirk preserved from fsk.c:583-584: the last block is windowed only
        # over the samples *beyond* the next block boundary (nin-(j+1)*Ndft)
        fft_samps = jnp.clip(nin - (j + 1) * Ndft, 0, Ndft)
        win = jnp.where(idx < fft_samps, hann, 0.0)
        spec = compat.dft(blocks[j] * win, n_out=half)
        mag2 = jnp.square(spec.real) + jnp.square(spec.imag)
        bin_i = jnp.arange(half)
        band = (bin_i >= cfg.f_min_bin) & (bin_i < cfg.f_max_bin - 1)
        mag = jnp.sqrt(jnp.where(band, mag2, 0.0))
        upd = fft_est * (1 - tc) + mag * tc
        fft_est = jnp.where(j < n_blocks, upd, fft_est)

    # M peak picks with blanking (fsk.c:633-654) on a copy.  First-max
    # index via one variadic reduce per peak (argmax_first) — identical to
    # argmax's first-occurrence semantics at half the reduction ops
    work = fft_est
    off = jnp.arange(half)
    peaks = []
    for _ in range(cfg.M):
        _, imax = argmax_first(work)
        peaks.append(imax)
        blank = (off >= imax - cfg.f_zero_bins) & (off < imax + cfg.f_zero_bins)
        work = jnp.where(blank, 0.0, work)
    if cfg.M == 2:
        lo = jnp.minimum(peaks[0], peaks[1])
        hi = jnp.maximum(peaks[0], peaks[1])
        freqs = jnp.stack([lo, hi]).astype(jnp.float32) * (cfg.Fs / Ndft)
    else:
        freqs = jnp.sort(jnp.stack(peaks)).astype(jnp.float32) * (cfg.Fs / Ndft)
    return fft_est, freqs


def _demod_frame(cfg: FSKConfig, state: DemodState, stream, new_blocks, hann,
                 with_probe: bool = False):
    """Demodulate one frame (fsk2_demod, fsk.c:679-1108), pure-functional.

    stream: (Nmem,) complex64 = the reference's [samp_old tail | fsk_in]
            concatenation — always Nmem samples, nold = Nmem - nin of history.
    new_blocks: (max_fft_blocks*Ndft,) complex64 — fresh samples for the
            frequency estimator (== stream[nold:nold+...], pre-gathered by
            the caller at a static offset).
    """
    Ts, P, M, Nsym, Nmem = cfg.Ts, cfg.P, cfg.M, cfg.Nsym, cfg.Nmem
    S = Ts // P
    nin = state.nin
    nold = Nmem - nin

    fft_est, f_new = _freq_est_step(cfg, state.fft_est, new_blocks, nin, hann)

    # first-run latch (fsk.c:750-753)
    latched = jnp.where(state.f_est[0] < 1.0, f_new, state.f_est)

    # --- downconvert: old samples spin at the latched (previous) estimate,
    # new samples at this frame's estimate, phase-continuous (fsk.c:756-826)
    inv_fs = np.float32(1.0 / cfg.Fs)
    t = jnp.arange(Nmem, dtype=jnp.float32)[None, :]          # (1, Nmem)
    noldf = nold.astype(jnp.float32)
    f_old = latched[:, None]
    f_cur = f_new[:, None]
    theta0 = state.phi[:, None] - TWO_PI * (noldf - S) * f_old * inv_fs
    ang = theta0 + TWO_PI * inv_fs * (
        f_old * jnp.minimum(t, noldf) + f_cur * jnp.maximum(t - noldf, 0.0))
    osc = jax.lax.complex(jnp.cos(ang), -jnp.sin(ang))        # e^{-j ang}
    d = stream[None, :] * osc                                  # (M, Nmem)

    # carrier phase after consuming Nmem - S samples (net +nin per frame)
    phi_next = jnp.mod(
        theta0[:, 0] + TWO_PI * inv_fs * (latched * noldf + f_new * (nin.astype(jnp.float32) - S)),
        np.float32(TWO_PI))

    # --- integrate-and-dump at P phases (fsk.c:766-842): window sums of
    # length Ts at stride Ts/P, as one banded matmul in place of cumsum +
    # concat + two gathers; numerically this is also the C chain's direct
    # per-window summation (fsk.c accumulates each integrator
    # independently) rather than a cumsum difference
    starts = np.arange((Nsym + 1) * P, dtype=np.int32) * S     # static
    t_i = jnp.arange(Nmem)[:, None]
    s_i = jnp.asarray(starts)[None, :]
    Wsum = ((t_i >= s_i) & (t_i < s_i + Ts)).astype(jnp.float32)
    # HIGHEST precision: a float32 matmul on the GPU may otherwise run in
    # TF32 (10-bit mantissa), which would silently degrade the integrators
    # near the decode cliff.  Real and imag parts ride ONE matmul (stacked
    # rows) — each output row is the same independent dot-product
    # reduction, so this is bit-exact vs two separate matmuls, at half the
    # matmul-op count
    ri = jnp.concatenate([jnp.real(d), jnp.imag(d)], axis=0)   # (2M, Nmem)
    prod = jnp.matmul(ri, Wsum, precision=jax.lax.Precision.HIGHEST)
    f_int = jax.lax.complex(prod[:M], prod[M:])

    # --- fine timing: magic spectral line at Rs (fsk.c:857-884)
    ft1 = jnp.sum(jnp.square(f_int.real) + jnp.square(f_int.imag), axis=0)
    spin = jnp.exp(1j * (TWO_PI / P) * jnp.arange((Nsym + 1) * P))
    t_c = jnp.sum(ft1.astype(jnp.complex64) * spin.astype(jnp.complex64))
    norm_rx_timing = compat.atan2(t_c.imag, t_c.real) / np.float32(TWO_PI)
    rx_timing = norm_rx_timing * P

    # clock-offset ppm IIR, gated on jumps (fsk.c:886-896)
    d_norm = norm_rx_timing - state.norm_rx_timing
    appm = 1e6 * d_norm / Nsym
    ppm = jnp.where(jnp.abs(d_norm) < 0.2,
                    0.9 * state.ppm + 0.1 * appm, state.ppm)

    # elastic nin for next frame (fsk.c:898-907)
    nin_next = jnp.where(
        norm_rx_timing > 0.25, cfg.N + Ts // 2,
        jnp.where(norm_rx_timing < -0.25, cfg.N - Ts // 2, cfg.N)).astype(jnp.int32)

    # --- symbol sampling with linear interpolation (fsk.c:912-981).
    # rx_timing lies in (-P/2, P/2]; floor/ceil and the timing-offset gather
    # are built from comparisons + static shifts (static gathers
    # vectorize better than dynamic takes)
    k_lo, k_hi = -(P // 2) - 1, P // 2 + 1
    low = compat.floor_int(rx_timing, k_lo, k_hi)
    fract = rx_timing - low.astype(jnp.float32)
    high = low + (fract > 0).astype(jnp.int32)                 # == ceil
    st = (np.arange(Nsym, dtype=np.int32) + 1) * P             # static
    # one static-window gather + a one-hot contraction, replacing a
    # 13-iteration select loop (~65 HLO ops -> ~5): low/fract are scalars
    # per frame, so the interpolation weights collapse to a (13,) vector
    # w[k] = (1-fract)*[low==k] + fract*[high==k]; the zero terms multiply
    # to exact 0.0 and the two live terms add exactly as the loop did, so
    # the rewrite is BIT-EXACT.
    offs = np.arange(k_lo, k_hi + 1, dtype=np.int32)           # (13,) static
    win = f_int[:, st[:, None] + offs[None, :]]                # (M, Nsym, 13)
    k_ar = jnp.asarray(offs)
    w = (jnp.where(k_ar == low, 1.0, 0.0) * (1 - fract)
         + jnp.where(k_ar == high, 1.0, 0.0) * fract)          # (13,) f32
    tv = jnp.sum(win * w[None, None, :], axis=-1)
    tmax = jnp.square(tv.real) + jnp.square(tv.imag)           # (M, Nsym)

    if M == 2:
        # C decision: sym=1 iff tmax[1] > tmax[0] (ties -> 0, first-max)
        bits = (tmax[1] > tmax[0]).astype(jnp.uint8)
        sym = bits.astype(jnp.int32)
        mags = jnp.sqrt(tmax)
        soft = mags[0] - mags[1]
    else:
        sym = jnp.argmax(tmax, axis=0)                         # first-max wins
        bits = jnp.stack([(sym >> 1) & 1, sym & 1], axis=-1).reshape(-1).astype(jnp.uint8)
        mags = jnp.sqrt(tmax)
        s1 = -mags[0] + mags[1] - mags[2] + mags[3]
        s0 = -mags[0] - mags[1] + mags[2] + mags[3]
        soft = jnp.stack([s0, s1], axis=-1).reshape(-1)

    # --- Eb/N0 estimate from winning magnitudes (fsk.c:984-1009)
    win = jnp.max(tmax, axis=0)
    meane = jnp.mean(jnp.sqrt(win))
    stde = jnp.mean(win) - meane * meane
    stde = jnp.sqrt(jnp.maximum(stde, 0.0))
    ebno_db = -6 + 20 * jnp.log10((1e-6 + meane) / (1e-6 + stde))
    snr_est = 0.5 * state.snr_est + 0.5 * ebno_db

    new_state = DemodState(
        pos=state.pos + nin, nin=nin_next, fft_est=fft_est, f_est=f_new,
        phi=phi_next, norm_rx_timing=norm_rx_timing, ppm=ppm,
        ebno_db=ebno_db, snr_est=snr_est)
    out = FrameOut(soft=soft, bits=bits, valid=jnp.bool_(True), f_est=f_new,
                   ebno_db=ebno_db, norm_rx_timing=norm_rx_timing, ppm=ppm,
                   nin=nin)
    if with_probe:
        return new_state, out, {"f_int": f_int, "rx_timing": rx_timing,
                                "high_sample": high}
    return new_state, out


def eye_diagram(f_int: np.ndarray, P: int, high_sample: int, M: int,
                max_ind: int = 160, et_max: int = 8,
                normalise: bool = True) -> np.ndarray:
    """Eye-diagram traces from the integrator outputs (fsk.c:1031-1079):
    per tone, `et_max/M` two-symbol windows of |f_int| centred on the
    timing estimate, decimated to fit max_ind samples, normalised to 1."""
    neyesamp_dec = int(np.ceil(2 * P / max_ind))
    neyesamp = (2 * P) // neyesamp_dec
    offset = int(high_sample) + 1
    traces = et_max // M
    eye = np.zeros((traces * M, neyesamp), np.float32)
    for i in range(traces):
        for m in range(M):
            idx = 2 * P * i + offset + np.arange(neyesamp) * neyesamp_dec
            eye[i * M + m] = np.abs(f_int[m, idx])
    if normalise and eye.max() > 0:
        eye = eye / eye.max()
    return eye


# ------------------------------------------------------------ stream driver


@partial(jax.jit, static_argnames=("cfg", "num_frames", "with_eye", "unroll",
                                   "frames_per_step"))
def demod_stream(cfg: FSKConfig, iq: jnp.ndarray, num_frames: int,
                 state: DemodState | None = None, n_valid=None,
                 with_eye: bool = False, unroll: int = 1,
                 frames_per_step: int = 1):
    """Demodulate a capture: iq (n,) complex64 -> per-frame FrameOut stack.

    The fread(nin)/samp_old state machine (fsk_demod.c:270, fsk.c:187-199)
    becomes a scan whose carry holds a read pointer into the zero-padded
    capture; each step gathers ONE slack window at a dynamic offset and
    demodulates `frames_per_step` consecutive frames from it.  Frames that
    would read past the end are masked invalid and freeze the carry (the C
    loop simply exits at EOF).

    n_valid: optional traced count of real samples in `iq` (the rest being
    padding), so streaming callers can bucket buffer shapes without
    recompiling.

    with_eye: additionally return (f_int, high_sample) of the LAST valid
    frame — the integrator outputs the eye diagram is traced from
    (fsk.c:1031-1079; emitted in fsk_demod's --stats JSON, fsk_demod.c:
    366-377).  Carried through the scan, so the cost is one where-select
    of a (M, (Nsym+1)*P) array per frame.

    frames_per_step (static): frames demodulated per scan step.  Under
    vmap (the fused chunk path) the per-step window gather is a per-LANE-
    varying dynamic_slice that lowers to a gather — F frames per step
    amortize that gather F-fold.  Frame
    j > 0 inside a step derives its window from frame j-1's by a 3-way
    static-slice select on nin (the same select the single-frame path
    already uses), so the samples every VALID frame sees are IDENTICAL to
    the F=1 path: outputs are bit-exact for any F on valid frames.
    (Frames past the capture end carry valid=False and their output
    fields are unmasked garbage — different garbage per F, since the
    frozen-state window plumbing differs; every caller must mask by
    `valid`, as all in-repo callers do.)
    """
    F = frames_per_step
    n = iq.shape[0] if n_valid is None else n_valid
    if state is None:
        state = demod_init(cfg)
        # tie the zero-init carry to iq so it is device-varying under
        # shard_map (scan carries must keep a consistent varying type)
        z = iq[0].real * 0.0
        state = jax.tree.map(lambda a: a + z.astype(a.dtype), state)
    hann = jnp.asarray(hann_window(cfg.Ndft))

    NB = cfg.Ndft * cfg.max_fft_blocks
    half_ts = cfg.Ts // 2                     # elastic-nin step (fsk.c:898)
    nin_min = cfg.N - half_ts
    # per-frame window shrink: offsets are 0 / half_ts / 2*half_ts — NOT
    # Ts: for odd Ts (e.g. the GQRX 48 kHz config, Ts=5) 2*(Ts//2) = Ts-1
    adv = nin_min + 2 * half_ts               # == nin_max
    wlen = max(2 * half_ts + cfg.Nmem, cfg.Nmem - nin_min + NB)
    # frame j's local window length inside the step (frame F-1 needs the
    # baseline wlen; each earlier frame needs one nin_max more so the
    # next frame's window is a slice of the current select)
    L = [wlen + (F - 1 - j) * adv for j in range(F)]
    pad_front = cfg.Nmem
    pad_back = cfg.Nmem + NB + (F - 1) * adv
    buf = jnp.concatenate([
        jnp.zeros(pad_front, jnp.complex64), iq.astype(jnp.complex64),
        jnp.zeros(pad_back, jnp.complex64)])
    steps = -(-num_frames // F)

    def one_frame(st, W, j, eye_carry):
        """Demod frame j of the step from local window W (length L[j],
        anchored at st.pos + nin_min - Nmem).  nin only ever takes
        {N - Ts/2, N, N + Ts/2}, so the Nmem history window is a 3-way
        select of STATIC slices and the freq-est block a static slice
        (bit-exact: the selected elements are identical)."""
        valid = st.pos + st.nin <= n
        d0 = st.nin - nin_min                 # in {0, half_ts, 2*half_ts}
        span = cfg.Nmem if j == F - 1 else nin_min + L[j + 1]
        s_a = jax.lax.slice(W, (0,), (span,))
        s_b = jax.lax.slice(W, (half_ts,), (half_ts + span,))
        s_c = jax.lax.slice(W, (2 * half_ts,), (2 * half_ts + span,))
        sel = jnp.where(d0 == 0, s_a, jnp.where(d0 == half_ts, s_b, s_c))
        stream = jax.lax.slice(sel, (0,), (cfg.Nmem,))
        new_blocks = jax.lax.slice(
            W, (cfg.Nmem - nin_min,), (cfg.Nmem - nin_min + NB,))
        if with_eye:
            nst, out, probe = _demod_frame(cfg, st, stream, new_blocks, hann,
                                           with_probe=True)
            eye_carry = jax.tree.map(
                lambda a, b: jnp.where(valid, a, b),
                (probe["f_int"], probe["high_sample"]), eye_carry)
        else:
            nst, out = _demod_frame(cfg, st, stream, new_blocks, hann)
        nst = jax.tree.map(lambda a, b: jnp.where(valid, a, b), nst, st)
        out = out._replace(valid=valid)
        # next frame's window starts nin further on: sel is already the
        # window advanced by nin - nin_min, so one more STATIC slice at
        # nin_min lands it.  (After a freeze the advanced window carries
        # garbage, but every subsequent frame is invalid and masked.)
        W_next = (jax.lax.slice(sel, (nin_min,), (nin_min + L[j + 1],))
                  if j < F - 1 else None)
        return nst, out, W_next, eye_carry

    def step(carry, _):
        st = carry[0] if with_eye else carry
        eye_c = carry[1] if with_eye else None
        W = jax.lax.dynamic_slice(
            buf, (pad_front + st.pos + (nin_min - cfg.Nmem),), (L[0],))
        outs_f = []
        for j in range(F):
            st, out, W, eye_c = one_frame(st, W, j, eye_c)
            outs_f.append(out)
        if F == 1:
            outs = outs_f[0]
        else:
            outs = jax.tree.map(lambda *xs: jnp.stack(xs), *outs_f)
        return ((st, eye_c) if with_eye else st), outs

    if with_eye:
        eye0 = (jnp.zeros((cfg.M, (cfg.Nsym + 1) * cfg.P), jnp.complex64),
                jnp.zeros((), jnp.int32))
        (final, eye), outs = jax.lax.scan(step, (state, eye0), None,
                                          length=steps, unroll=unroll)
    else:
        final, outs = jax.lax.scan(step, state, None, length=steps,
                                   unroll=unroll)
    if F > 1:
        # (steps, F, ...) -> (steps*F, ...), truncated to the requested
        # frame count (the overhang frames are provably invalid: frame
        # num_frames onward would start past the last consumable sample)
        outs = jax.tree.map(
            lambda a: a.reshape(steps * F, *a.shape[2:])[:num_frames], outs)
    return (final, outs, eye) if with_eye else (final, outs)


def demod_iq_np(cfg: FSKConfig, iq: np.ndarray, state: DemodState | None = None):
    """Host convenience: demod a whole capture, return concatenated soft bits
    (exactly what `fsk_demod -s` writes to stdout) plus the frame stats."""
    iq = np.asarray(iq, np.complex64)
    nf = cfg.num_frames(len(iq))
    final, outs = demod_stream(cfg, compat.put_complex(iq), nf, state)
    outs = jax.tree.map(np.asarray, outs)
    valid = outs.valid
    return outs.soft[valid].reshape(-1), outs, final


# ------------------------------------------------------- sample conversion


FDMDV_SCALE = 825.0   # src/codec2_fdmdv.h:113


def iq_from_cu8(raw: np.ndarray) -> np.ndarray:
    """Complex u8 -> complex64, (x-127)/128 (fsk_demod.c:281-287)."""
    raw = np.asarray(raw, np.uint8).astype(np.float32)
    return ((raw[0::2] - 127.0) + 1j * (raw[1::2] - 127.0)).astype(np.complex64) / 128.0


def iq_from_cs16(raw: np.ndarray) -> np.ndarray:
    """Complex s16 -> complex64, /FDMDV_SCALE (fsk_demod.c:289-296)."""
    raw = np.asarray(raw, np.int16).astype(np.float32)
    return ((raw[0::2] + 1j * raw[1::2]) / FDMDV_SCALE).astype(np.complex64)


def iq_from_s16_real(raw: np.ndarray) -> np.ndarray:
    """Real s16 -> complex64 (imag 0), /FDMDV_SCALE (fsk_demod.c:273-279)."""
    raw = np.asarray(raw, np.int16).astype(np.float32)
    return (raw / FDMDV_SCALE).astype(np.complex64)


def iq_to_cu8(iq: np.ndarray) -> np.ndarray:
    """complex64 -> interleaved u8, inverse of iq_from_cu8 with clipping
    (matches csdr convert_f_u8's 127-offset convention)."""
    x = np.empty(2 * len(iq), np.float32)
    x[0::2] = np.real(iq)
    x[1::2] = np.imag(iq)
    return np.clip(np.round(x * 128.0 + 127.0), 0, 255).astype(np.uint8)
