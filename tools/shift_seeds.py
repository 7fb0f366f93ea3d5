#!/usr/bin/env python3
"""Run an example trainer with every seed it sets shifted by K, to tell a
seed's effect on a result from a fault.

    python tools/shift_seeds.py K examples/train_nerf_synthetic.py --cpu ...
    python tools/shift_seeds.py K examples_torch/train_nerf_synthetic.py ...

A JAX example (`examples/`) runs unchanged, with `jax.random.key` and
`jax.random.PRNGKey` adding K to their seed: its draws, its evaluation
rays and its models' initialisation (`nnx.Rngs`) all move. A port trainer
(`examples_torch/`) runs with `examples_torch.common.SEED_SHIFT = K`,
which its generators and its model's initialisation seed add.
"""

import os
import runpy
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    shift, script, argv = int(sys.argv[1]), sys.argv[2], sys.argv[3:]
    sys.path.insert(0, ROOT)
    sys.argv = [script] + argv
    if os.path.basename(os.path.dirname(os.path.abspath(script))) == \
            "examples_torch":
        from examples_torch import common

        common.SEED_SHIFT = shift
    else:
        import jax

        key, prng_key = jax.random.key, jax.random.PRNGKey
        jax.random.key = lambda seed, *a, **k: key(seed + shift, *a, **k)
        jax.random.PRNGKey = lambda seed, *a, **k: prng_key(seed + shift,
                                                            *a, **k)
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    main()
