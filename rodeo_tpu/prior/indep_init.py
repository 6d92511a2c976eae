r"""
Collapse stacked block prior parameters into a single dense block.

Used for non-blocked operation (one big ``(d*q, d*q)`` state instead of ``d``
independent ``(q, q)`` blocks).  Functional parity target:
``/root/reference/src/rodeo/prior/indep_init.py``.
"""
import jax.numpy as jnp
import jax.scipy.linalg as jsl

__all__ = ["indep_init"]


def _block_diag_stacked(blocks):
    """Block-diagonal of a stacked ``(n_block, p, q)`` array as ONE
    vectorized scatter.  ``jax.scipy.linalg.block_diag(*blocks)`` issues
    one dynamic-update-slice per block — at d=1024 that is ~2k eager
    dispatches before the solver even traces."""
    n, p, q = blocks.shape
    out = jnp.zeros((n, p, n, q), blocks.dtype)
    idx = jnp.arange(n)
    out = out.at[idx, :, idx, :].set(blocks)
    return out.reshape(n * p, n * q)


def indep_init(prior_pars):
    r"""
    Combine blocks of prior parameters into dense matrices.

    Args:
        prior_pars (tuple): ``(prior_weight, prior_var)`` stacked block
            arrays of shape ``(n_block, p, p)``.

    Returns:
        (tuple): ``(prior_weight, prior_var)`` as single dense blocks of
        shape ``(1, n_block * p, n_block * p)``.
    """
    prior_weight, prior_var = prior_pars
    return (_block_diag(prior_weight)[None, :],
            _block_diag(prior_var)[None, :])


def _block_diag(blocks):
    try:
        stacked = jnp.asarray(blocks)
    except (ValueError, TypeError):
        stacked = None
    if stacked is not None and stacked.ndim == 3:
        return _block_diag_stacked(stacked)
    # Ragged block sizes (not produced by ibm_init, but legal upstream).
    return jsl.block_diag(*blocks)
