"""Helpers the port's parity tests share: a quicker-compiling `jax.jit`
for the reference, and the port's initial weights as a reference
parameter tree (so the reference's init is never compiled)."""

import functools

import jax
import jax.numpy as jnp

# XLA's lowest CPU backend optimisation level: fast math stays off, so the
# reference computes the same values; its compiles take about a third less
jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})


def reference_tree(module, init, *args):
    """The port module's values laid out as the reference's parameter tree
    `init(*args)`, whose structure comes from `jax.eval_shape` alone."""
    own = module.state_dict()

    def leaf(path, shape):
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        return jnp.asarray(own[key].numpy(), shape.dtype)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(init, *args))
