"""Internal-signal tracing (src/modem_probe.c equivalent).

The reference compiles optional named-trace hooks into the C demod and
dumps an Octave workspace (modem_probe.c:62-141).  The functional JAX demod
makes this trivial: `probe_demod` re-runs the per-frame step over a capture
collecting named intermediate arrays — no recompilation flags, no global
state — and `save_npz` replaces the Octave dump with an .npz workspace.

Trace names mirror the reference's (fsk.c:631,726,909-910,1089-1099):
  t_fft_est, t_f_est, t_norm_rx_timing, t_nin, t_EbNodB, t_ppm
plus rx soft/hard outputs.  jax.profiler helpers cover the timing side.
"""
from __future__ import annotations

import contextlib

import numpy as np

from . import compat


def probe_demod(cfg, iq: np.ndarray, num_frames: int | None = None) -> dict:
    """Demodulate and return named per-frame traces."""
    import jax
    import jax.numpy as jnp

    from ..ops import fsk

    iq = np.asarray(iq, np.complex64)
    nf = cfg.num_frames(len(iq)) if num_frames is None else num_frames

    hann = jnp.asarray(fsk.hann_window(cfg.Ndft))
    pad_front = cfg.Nmem
    pad_back = cfg.Nmem + cfg.Ndft * cfg.max_fft_blocks
    buf = jnp.concatenate([
        jnp.zeros(pad_front, jnp.complex64), compat.put_complex(iq),
        jnp.zeros(pad_back, jnp.complex64)])
    n = len(iq)

    def step(st, _):
        valid = st.pos + st.nin <= n
        nold = cfg.Nmem - st.nin
        stream = jax.lax.dynamic_slice(
            buf, (pad_front + st.pos - nold,), (cfg.Nmem,))
        new_blocks = jax.lax.dynamic_slice(
            buf, (pad_front + st.pos,), (cfg.Ndft * cfg.max_fft_blocks,))
        nst, out, extra = fsk._demod_frame(cfg, st, stream, new_blocks, hann,
                                           with_probe=True)
        nst = jax.tree.map(lambda a, b: jnp.where(valid, a, b), nst, st)
        trace = {
            "t_fft_est": nst.fft_est,
            "t_f_est": out.f_est,
            "t_norm_rx_timing": out.norm_rx_timing,
            "t_nin": out.nin,
            "t_EbNodB": out.ebno_db,
            "t_ppm": out.ppm,
            "t_f_int": extra["f_int"],
            "t_rx_timing": extra["rx_timing"],
            "t_high_sample": extra["high_sample"],
            "rx_sd": out.soft,
            "rx_bits": out.bits,
            "valid": valid,
        }
        return nst, trace

    _, traces = jax.lax.scan(step, fsk.demod_init(cfg), None, length=nf)
    return {k: np.asarray(v) for k, v in traces.items()}


def eye_traces(cfg, traces: dict, frame: int = -1) -> np.ndarray:
    """Eye diagram for one probed frame (fsk_demod stats JSON
    'eye_diagram' field)."""
    from ..ops import fsk

    valid = np.flatnonzero(traces["valid"])
    f = valid[frame]
    return fsk.eye_diagram(traces["t_f_int"][f], cfg.P,
                           traces["t_high_sample"][f], cfg.M)


def save_npz(path: str, traces: dict) -> None:
    """Dump a probe workspace (the Octave-file role of modem_probe_close)."""
    np.savez_compressed(path, **traces)


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax profiler trace around a region (TensorBoard-compatible)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
