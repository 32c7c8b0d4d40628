"""Every float matrix product of the demod path names HIGHEST precision.

On the GPU a float32 product without it may run in TF32 (10-bit mantissa),
which would quietly move the tone estimator, the integrators and the
channelizer near the decode cliff.  Checked on the traced programs, so it
holds whatever the backend."""
import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

from wenet_tpu.ops import channelizer, fsk
from wenet_tpu.utils import compat

CFG = fsk.FSKConfig(Fs=96000, Rs=9600)


def _dot_precisions(jaxpr):
    """precision params of every dot_general, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _channelize():
    return jax.make_jaxpr(lambda x: channelizer.channelize(x, 8))(
        jnp.zeros(8 * 64, jnp.complex64))


def _dft():
    return jax.make_jaxpr(lambda x: compat.dft(x, n_out=32))(
        jnp.zeros((4, 64), jnp.complex64))


def _demod():
    n = 20 * CFG.N
    return jax.make_jaxpr(
        lambda x: fsk.demod_stream(CFG, x, CFG.num_frames(n),
                                   frames_per_step=2))(
        jnp.zeros(n, jnp.complex64))


@pytest.mark.parametrize("trace", [_channelize, _dft, _demod],
                         ids=["channelize", "dft", "demod"])
def test_every_dot_general_is_highest(trace):
    precs = _dot_precisions(trace().jaxpr)
    assert precs, "no matrix product traced"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(q == hi for q in np.atleast_1d(p)), p
