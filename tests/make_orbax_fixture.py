"""Regenerate tests/data/orbax_jax_tiny/ and tests/data/orbax_jax_tiny.ckpt:
a snapshot that the JAX package writes with `checkpoint_backend: orbax`,
and its twin in the JAX package's msgpack format, for the port's orbax
reader on a host without orbax or tensorstore.

The state is that of the tiny configuration of test_torch_pipeline.py's
`_param` after 2 JAX train steps (weights, both Adam moments, step,
iteration), less its leaves above 64 KiB (the 30522-row embeddings and
tag decoder, and their moments: the pair stays under 4 MiB), plus an
`extra` subtree of structured leaves whose zstd frames
hold every block and section kind the reader decodes: all-zero and
repeated-row arrays (RLE and compressed blocks with FSE-coded sequences),
random bytes (raw blocks), small-range integers, bf16, int32, int64 and
uint8 leaves, 0-d, 1-d and 2-d.

  JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_orbax_fixture.py [OUT]

writes OUT/orbax_jax_tiny and OUT/orbax_jax_tiny.ckpt (OUT defaults to
tests/data).
"""

import os
import shutil
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS",
                                                                 ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=8").strip()

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

NAME = "orbax_jax_tiny"


def extra_leaves():
    """The structured leaves, made from a seed."""
    import jax.numpy as jnp
    import numpy as np
    rs = np.random.RandomState(7)
    row = rs.standard_normal(96).astype(np.float32)
    return {
        "zeros": np.zeros((256, 256), np.float32),
        "rows": np.tile(row, (400, 1)),
        "noisy_rows": (np.tile(row, (300, 1))
                       + (rs.rand(300, 96) < 0.02) * 1.0).astype(np.float32),
        "random_u8": rs.randint(0, 256, 140_000).astype(np.uint8),
        "small_i32": rs.randint(0, 4, (128, 300)).astype(np.int32),
        "small_i64": rs.randint(-3, 3, 10_000).astype(np.int64),
        "bf16": jnp.asarray(rs.standard_normal((64, 48)), jnp.bfloat16),
        "scalar_f32": np.float32(3.25),
        "scalar_i32": np.int32(-7),
    }


def small(tree, limit=64 << 10):
    """`tree` without its array leaves of more than `limit` bytes."""
    import numpy as np
    if isinstance(tree, dict):
        return {k: small(v, limit) for k, v in tree.items()
                if isinstance(v, (dict, list)) or np.asarray(v).nbytes
                <= limit}
    if isinstance(tree, list):
        return [small(v, limit) for v in tree]
    return tree


def build(out_dir: str) -> None:
    """Train 2 JAX steps with orbax snapshots in a scratch directory and
    write the fixture pair into `out_dir`."""
    import jax
    import numpy as np
    import torch

    import run as JR
    from test_torch_pipeline import TEST, _param, make_dataset, seeded
    from vitcap_tpu.models import vitcap as JM
    from vitcap_tpu.pipelines import caption_pipeline as JCP
    from vitcap_tpu.solver import checkpoint_bridge as JB
    from vitcap_tpu.solver import checkpointing as JCK
    from vitcap_tpu.solver import train_step as JTS

    with tempfile.TemporaryDirectory() as root:
        make_dataset(root)
        param = _param(root, "out", max_iter=2, ignore_predict=True,
                       checkpoint_backend="orbax")
        jcfg = JCP.CaptionUniPipeline(**param).model_cfg
        params = jax.tree_util.tree_map(
            np.asarray, JM.init_params(jax.random.PRNGKey(3), jcfg))
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                    JB.params_to_torch_state_dict(params).items()},
                   os.path.join(root, "base.pt"))
        with seeded(JCP, JTS, "make_jitted_train_step", []):
            JR.pipeline_train_eval_multi(TEST, param)
        snap = os.path.join(param["output_root"], "tinycoco_tiny_parity",
                            "snapshot", "model_iter_0000002.orbax")
        state = JCK.load_state(snap)
        state = {"params": small(state["params"]),
                 "opt": small(state["opt"]), "extra": extra_leaves()}
        work = os.path.join(root, "fixture")
        ck = JCK.Checkpointer(work, backend="orbax")
        made = ck.save(2, state)
        os.makedirs(out_dir, exist_ok=True)
        target = os.path.join(out_dir, NAME)
        if os.path.exists(target):
            shutil.rmtree(target)
        shutil.copytree(made, target)
        JCK.save_state(os.path.join(out_dir, NAME + ".ckpt"),
                       JCK.load_state(target))


if __name__ == "__main__":
    build(sys.argv[1] if len(sys.argv) > 1 else os.path.join(HERE, "data"))
