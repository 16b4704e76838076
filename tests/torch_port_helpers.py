"""Shared pieces of the torch port's parity tests (imported by
tests/test_torch_port_*.py, like torch_resnet_oracle.py for the oracle
tests)."""

import jax
import jax.numpy as jnp
import numpy as np

# the reduced TResNet both sides build for parity on the CPU
REDUCED = dict(num_classes=10, stages=(1, 1, 1, 1), width=0.5)
# the train-step parity tests' recipe: SGD with momentum and weight decay
# under a linear warmup and a StepLR decay
OPTIM = dict(optimizer="sgd", lr=0.05, momentum=0.9, weight_decay=1e-4,
             schedule="step", step_size=1, gamma=0.5, warmup_iters=2,
             warmup_start_lr=0.01)


def init_variables(model, image_size: int):
    """flax `init` under jit (eager init compiles op by op: ~4x slower on
    the CPU)."""
    x = jnp.zeros((1, image_size, image_size, 3))
    return jax.jit(lambda k: model.init(k, x, train=False))(
        jax.random.PRNGKey(0))


def randomize_bn(params, stats, rng):
    """Randomize every BN γ/β and running mean/var (and every bias) so a
    scale↔bias or mean↔var swap in the mapping cannot hide behind the
    init's 1/0 values."""
    params = jax.tree_util.tree_map(np.asarray, params)
    stats = jax.tree_util.tree_map(np.asarray, stats)

    def walk(p, s):
        for k, v in p.items():
            if isinstance(v, dict):
                walk(v, s.get(k, {}) if isinstance(s, dict) else {})
            elif k == "scale":
                p[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bias":
                p[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        if isinstance(s, dict) and "mean" in s:
            s["mean"] = rng.normal(0.0, 0.2, s["mean"].shape).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)

    walk(params, stats)
    return params, stats


def random_variables(model, image_size: int, rng):
    """flax variables for `model` without compiling its init: the tree's
    shapes from `jax.eval_shape`, filled from `rng` with conv and dense
    kernels N(0, 2/fan_in), every BN γ/β and running mean/var randomized
    as `randomize_bn` does, and zero elsewhere (the init's compile is the
    slowest part of a parity test at full depth on the CPU)."""
    x = jax.ShapeDtypeStruct((1, image_size, image_size, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros(x.shape),
                           train=False))

    def fill(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0.0, np.sqrt(2.0 / fan_in),
                              leaf.shape).astype(np.float32)
        return np.zeros(leaf.shape, np.float32)

    filled = jax.tree_util.tree_map_with_path(fill, shapes)
    return randomize_bn(filled["params"], filled.get("batch_stats", {}), rng)
