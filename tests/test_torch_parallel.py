"""vitcap_tpu_torch's data parallelism (parallel/, the train step, SCST
and the pipelines over torch.distributed) on the CPU.

The helpers are checked in this process; every multi-rank case spawns real
peer processes over Gloo (this file run as a script: `python
tests/test_torch_parallel.py <mode> <rank> <world> <port> <dir>`, or
`python -m torch.distributed.run ... -m vitcap_tpu_torch.run` for the
pipeline), each with a timeout of its own.  The 2-rank train step is held
to the JAX package's single-process jitted step over the whole batch
(tests/test_multiprocess.py's tolerances: loss rtol 1e-5, parameters rtol
2e-4 / atol 1e-6) on a batch whose halves mask different numbers of
tokens, where a per-rank mean (DDP's rule) would be off.
"""

import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.solver import train_step as JT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from vitcap_tpu_torch import run as TR                       # noqa: E402
from vitcap_tpu_torch.data.tokenization import DEFAULT_VOCAB  # noqa: E402
from vitcap_tpu_torch.data.tsv import tsv_reader, tsv_writer  # noqa: E402
from vitcap_tpu_torch.models import config as TC             # noqa: E402
from vitcap_tpu_torch.models import decode as TDec           # noqa: E402
from vitcap_tpu_torch.models import vitcap as TM             # noqa: E402
from vitcap_tpu_torch.parallel import distributed as TD      # noqa: E402
from vitcap_tpu_torch.parallel import mesh as TMesh          # noqa: E402
from vitcap_tpu_torch.solver import checkpoint_bridge as TB  # noqa: E402
from vitcap_tpu_torch.solver import scst as TS               # noqa: E402
from vitcap_tpu_torch.solver import train_step as TT         # noqa: E402

TIMEOUT = 300                 # seconds a spawned run may take
B = 8                         # global rows of the train-step batch
HYPER = dict(base_lr=1e-3, max_iter=10)
KW = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
          tag_loss_weight=1.0)
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
            "OMPI_COMM_WORLD_LOCAL_RANK")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env(**kw):
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    env.update(kw)
    return env


def _wait(procs):
    """(return code, output) of each process; every one is killed and the
    test fails if any outlives TIMEOUT."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out.decode(errors="replace")))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a spawned rank ran past {TIMEOUT} s")
    return outs


def _spawn(mode, workdir, world=2, ok=(0,)):
    """This file as a worker, one process a rank; returns their outputs."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         port, str(workdir)], env=_child_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = _wait(procs)
    for r, (rc, out) in enumerate(outs):
        assert rc in ok, f"rank {r} exited {rc}:\n{out[-4000:]}"
    return outs


# ---------------------------------------------------------------------------
# helpers, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def no_dist_env(monkeypatch):
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def captured(monkeypatch):
    """dist.init_process_group recorded instead of run."""
    calls = []
    monkeypatch.setattr(TD.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    return calls


@pytest.mark.parametrize("env, want", [
    ({}, None),
    ({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1234", "WORLD_SIZE": "4",
      "RANK": "3"}, ("tcp://127.0.0.1:1234", 4, 3)),
    ({"MASTER_ADDR": "10.0.0.2", "WORLD_SIZE": "2", "RANK": "0"},
     ("tcp://10.0.0.2:29500", 2, 0)),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "77", "OMPI_COMM_WORLD_SIZE": "8",
      "OMPI_COMM_WORLD_RANK": "5"}, ("tcp://h:77", 8, 5)),
], ids=["no_env", "torchrun", "default_port", "ompi"])
def test_env_parsing(no_dist_env, captured, monkeypatch, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    TD.ensure_init_distributed(device="cpu")
    if want is None:
        assert captured == []
        return
    (backend,), kw = captured[0]
    assert backend == "gloo"
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == want


def test_arguments_override_env_and_name_the_backend(no_dist_env, captured,
                                                      monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "ignored")
    monkeypatch.setenv("WORLD_SIZE", "9")
    TD.ensure_init_distributed("127.0.0.1:5", 2, 1, backend="nccl",
                               device="cpu")
    (backend,), kw = captured[0]
    assert backend == "nccl"
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == (
        "tcp://127.0.0.1:5", 2, 1)


def test_default_device_is_the_card(no_dist_env, captured, monkeypatch):
    """With no device named, the rank's device is the card: without one
    the init raises RuntimeError, from the arguments or the environment,
    and makes no group (never a quiet Gloo group on the CPU); device="cpu"
    makes the Gloo one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.ensure_init_distributed("127.0.0.1:5", 2, 1)
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("WORLD_SIZE", "2"),
                 ("RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.ensure_init_distributed()
    assert captured == []
    TD.ensure_init_distributed(device="cpu")
    (backend,), _ = captured[0]
    assert backend == "gloo"


def test_a_world_size_without_an_address_raises(no_dist_env, captured,
                                                 monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        TD.ensure_init_distributed(device="cpu")
    assert captured == []


def test_init_is_idempotent_and_keeps_a_callers_group(no_dist_env):
    """A real one-rank Gloo group: a second call, and a call that names
    other values, leave it as it is; the helpers are identities."""
    TD.ensure_init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                               device="cpu")
    try:
        group = torch.distributed.group.WORLD
        TD.ensure_init_distributed()
        TD.ensure_init_distributed("127.0.0.1:1", 4, 2, backend="nccl")
        assert torch.distributed.group.WORLD is group
        assert torch.distributed.get_backend() == "gloo"
        assert (TD.world_size(), TD.rank()) == (1, 0)
        TD.barrier("x")
        assert TD.any_process(True) and not TD.any_process(False)
        assert TD.all_gather_host({"a": 1}) == [{"a": 1}]
        g = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)}
        out, extra = TMesh.all_reduce_grads(g, torch.tensor([2.5, 3.0]))
        assert torch.equal(out["w"], g["w"]) and torch.equal(out["b"],
                                                             g["b"])
        assert extra.tolist() == [2.5, 3.0]
    finally:
        TD.shutdown()
    assert not torch.distributed.is_initialized()


def test_helpers_without_a_group_are_identities(no_dist_env):
    assert not torch.distributed.is_initialized()
    TD.barrier()
    assert TD.any_process(True) is True
    assert TD.all_gather_host(3) == [3]
    g = {"w": torch.ones(3)}
    out, extra = TMesh.all_reduce_grads(g)
    assert out is g and extra is None
    t = torch.ones(2)
    assert TMesh.all_reduce_sum(t) is t


@pytest.mark.parametrize("mesh_data, world, raises", [
    (None, 1, False), (None, 4, False), (2, 2, False), (1, 1, False),
    (2, 1, True), (1, 2, True), (8, 4, True)])
def test_mesh_data_must_be_the_world_size(mesh_data, world, raises):
    if raises:
        with pytest.raises(ValueError,
                           match=f"nproc_per_node {mesh_data}"):
            TMesh.check_mesh_data(mesh_data, world)
    else:
        TMesh.check_mesh_data(mesh_data, world)


def test_rank_device(monkeypatch):
    """'cuda' is cuda:LOCAL_RANK; an explicit index or the CPU as named;
    a LOCAL_RANK past the card count raises (no wrap-around, no CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert TMesh.rank_device("cuda", 1) == torch.device("cuda", 1)
    assert TMesh.rank_device("cuda:0", 1) == torch.device("cuda", 0)
    assert TMesh.rank_device("cpu", 5) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2"):
        TMesh.rank_device("cuda", 2)
    with pytest.raises(RuntimeError, match="2 CUDA device"):
        TMesh.rank_device("cuda:3", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMesh.rank_device("cuda", 0)


def test_local_rows_and_rank_seeds():
    batch = {"a": np.arange(8), "b": np.arange(16).reshape(8, 2)}
    r1 = TMesh.local_rows(batch, 1, 2)
    assert r1["a"].tolist() == [4, 5, 6, 7]
    assert r1["b"].tolist() == [[8, 9], [10, 11], [12, 13], [14, 15]]
    with pytest.raises(ValueError):
        TMesh.local_rows(batch, 0, 3)
    assert TMesh.rank_seed(88, 0) == 88
    seeds = {TMesh.rank_seed(88, r, s) for r in range(3) for s in (0, 5)}
    assert len(seeds) == 6


# ---------------------------------------------------------------------------
# the train step: 2 ranks over Gloo against the JAX package's global step
# ---------------------------------------------------------------------------

def _step_inputs(workdir):
    """The JAX tiny model's weights (as the port's state dict) and an
    8-row batch whose first half masks 1 token a row and second half 3."""
    jcfg = jax_tiny_config(**KW)
    cfg = TC.tiny_config(**KW)
    params = jax.tree_util.tree_map(
        np.array, JM.init_params(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(3)
    for path, a in TB.flatten_params(params).items():
        if path.endswith("bias"):          # non-zero, so they are tested
            a[...] = rs.randn(*a.shape).astype(np.float32) * 0.02
    T, A = cfg.max_seq_len, cfg.max_seq_a_len
    masked_pos = np.zeros((B, T), np.int32)
    masked_pos[:B // 2, 2] = 1
    masked_pos[B // 2:, [1, 3, 4]] = 1
    label = (rs.rand(B, cfg.tag_vocab_size) < 0.05).astype(np.float32)
    label[:, 5] = 1.0
    batch = {
        "image": rs.randn(B, cfg.img_size, cfg.img_size, 3)
                 .astype(np.float32),
        "input_ids": rs.randint(4, cfg.vocab_size, (B, T)).astype(np.int32),
        "token_type_ids": np.concatenate(
            [np.zeros((B, A), np.int32), np.ones((B, T - A), np.int32)], 1),
        "seq_a_len": np.full((B,), A, np.int32),
        "seq_len": np.array([T, T - 2] * (B // 2), np.int32),
        "masked_pos": masked_pos,
        "masked_ids": rs.randint(1, cfg.vocab_size,
                                 (B, cfg.max_masked_tokens)).astype(np.int32),
        "label": label,
    }
    sd = {k[len("module."):] if k.startswith("module.") else k:
          torch.from_numpy(np.ascontiguousarray(v))
          for k, v in TB.params_to_torch_state_dict(params).items()}
    torch.save(sd, os.path.join(workdir, "weights.pt"))
    np.savez(os.path.join(workdir, "batch.npz"), **batch)
    return jcfg, cfg, params, batch


def _torch_batch(batch):
    return {k: (torch.from_numpy(np.asarray(v)).long()
                if np.asarray(v).dtype == np.int32
                else torch.from_numpy(np.asarray(v)))
            for k, v in batch.items()}


def _load_model(cfg, workdir):
    model = TM.ViTCAP(cfg)
    model.load_state_dict(torch.load(os.path.join(workdir, "weights.pt")))
    return model


def test_two_rank_train_step_matches_jax_global_step(tmp_path):
    jcfg, cfg, params, batch = _step_inputs(str(tmp_path))
    _spawn("step", tmp_path)
    got = [dict(np.load(tmp_path / f"step_{r}.npz")) for r in range(2)]
    metrics = json.loads((tmp_path / "step_metrics.json").read_text())

    jstate = JT.init_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                 jax.random.PRNGKey(1))
    jstep = jax.jit(JT.make_train_step(jcfg, JT.TrainHyper(**HYPER)))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = float(jm["loss"])
    np.testing.assert_allclose(metrics["loss"], loss, rtol=1e-5, atol=1e-6)
    # test_torch_train_step.py's tolerance for the parts and probes
    for key in ("masked_loss", "tag_loss", "caption_acc", "tag_precision",
                "grad_norm"):
        np.testing.assert_allclose(metrics[key], float(jm[key]), rtol=2e-5,
                                   atol=1e-7, err_msg=key)
    ref = TB.flatten_params(jax.tree_util.tree_map(np.asarray,
                                                   jstate.params))
    assert got[0].keys() == ref.keys()
    for path, want in ref.items():
        np.testing.assert_array_equal(got[1][path], got[0][path])
        np.testing.assert_allclose(got[0][path], want, rtol=2e-4, atol=1e-6,
                                   err_msg=path)

    # the halves mask 1 and 3 tokens a row: DDP's rule, the mean of the
    # ranks' own losses, is off by more than the tolerance, in the masked
    # loss alone too
    model = _load_model(cfg, str(tmp_path))
    halves = [TM.forward_train(model, _torch_batch(
        {k: v[r * B // 2:(r + 1) * B // 2] for k, v in batch.items()}),
        cfg)[1] for r in range(2)]
    for key in ("loss", "masked_loss"):
        ddp = np.mean([h[key].item() for h in halves])
        assert abs(ddp - float(jm[key])) > 1e-5 * abs(float(jm[key])), key


def _run_step(rank, world, workdir):
    cfg = TC.tiny_config(**KW)
    batch = TMesh.local_rows(dict(np.load(os.path.join(workdir,
                                                       "batch.npz"))),
                             rank, world)
    model = _load_model(cfg, workdir)
    TMesh.replicate_params(model)
    state = TT.init_train_state(model, None)
    step = TT.make_train_step(cfg, TT.TrainHyper(**HYPER))
    state, m = step(state, _torch_batch(batch))
    np.savez(os.path.join(workdir, f"step_{rank}.npz"),
             **TB.state_to_jax_flat(dict(model.named_parameters())))
    if rank == 0:
        with open(os.path.join(workdir, "step_metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in m.items()}, f)


# ---------------------------------------------------------------------------
# SCST: 2 ranks against one rank over the whole batch
# ---------------------------------------------------------------------------

SCST_B, SCST_K = 4, 2


def _scst_inputs(cfg, seed=7):
    rs = np.random.RandomState(seed)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    A = cfg.max_gen_length
    batch = {
        "image": rs.randint(0, 256, (SCST_B, cfg.img_size, cfg.img_size, 3))
                 .astype(np.uint8),
        "od_ids": rs.randint(1, cfg.vocab_size, (SCST_B, od_len))
                  .astype(np.int32),
        "seq_len": np.array([cfg.max_seq_len, cfg.max_seq_len - 3] * 2,
                            np.int32),
    }
    ids = rs.randint(1, cfg.vocab_size, (SCST_B * SCST_K, A)).astype(np.int32)
    ids[:, 0] = cfg.cls_token_id
    ids[ids == cfg.sep_token_id] = 7
    ids[0, 3], ids[0, 4:] = cfg.sep_token_id, cfg.pad_token_id
    ids[5, 2], ids[5, 3:] = cfg.sep_token_id, cfg.pad_token_id
    samples = {"ids": ids, "raw": ids[:, 1:].copy(),
               "adv": rs.randn(SCST_B * SCST_K).astype(np.float32)}
    return batch, samples


def _scst_grad(cfg, model, batch, samples):
    opts = TDec.DecodeOptions(max_length=cfg.max_gen_length,
                              od_labels_start_posid=cfg.max_seq_a_len)
    _, grad = TS.make_scst_fns(cfg, opts, TS.ScstConfig(num_return=SCST_K),
                               TT.TrainHyper(**HYPER))
    state = TT.init_train_state(model, None)
    tb = _torch_batch(batch)
    n = batch["image"].shape[0]
    state, m = grad(state, tb, torch.from_numpy(samples["ids"]).long(),
                    torch.from_numpy(samples["raw"]).long(),
                    torch.from_numpy(samples["adv"]),
                    torch.zeros((n, 0), dtype=torch.long))
    return model, m


def test_two_rank_scst_step_matches_one_rank(tmp_path):
    """Each rank scores its own images' samples with their advantages (the
    sampled ids fixed, F3); the step equals one rank's over the whole
    batch (itself held to the JAX package by tests/test_torch_scst.py)."""
    cfg = TC.tiny_config(**KW)
    _step_inputs(str(tmp_path))
    _spawn("scst", tmp_path)
    got = [dict(np.load(tmp_path / f"scst_{r}.npz")) for r in range(2)]
    metrics = json.loads((tmp_path / "scst_metrics.json").read_text())
    batch, samples = _scst_inputs(cfg)
    model, m = _scst_grad(cfg, _load_model(cfg, str(tmp_path)), batch,
                          samples)
    for key in ("scst_loss", "mean_logprob", "grad_norm"):
        np.testing.assert_allclose(metrics[key], m[key].item(), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    ref = TB.state_to_jax_flat(dict(model.named_parameters()))
    for path, want in ref.items():
        np.testing.assert_array_equal(got[1][path], got[0][path])
        np.testing.assert_allclose(got[0][path], want, rtol=2e-4, atol=1e-6,
                                   err_msg=path)


def _run_scst(rank, world, workdir):
    cfg = TC.tiny_config(**KW)
    batch, samples = _scst_inputs(cfg)
    batch = TMesh.local_rows(batch, rank, world)
    samples = TMesh.local_rows(samples, rank, world)
    model = _load_model(cfg, workdir)
    TMesh.replicate_params(model)
    model, m = _scst_grad(cfg, model, batch, samples)
    np.savez(os.path.join(workdir, f"scst_{rank}.npz"),
             **TB.state_to_jax_flat(dict(model.named_parameters())))
    if rank == 0:
        with open(os.path.join(workdir, "scst_metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in m.items()}, f)


# ---------------------------------------------------------------------------
# the pipeline through the CLI, and preemption
# ---------------------------------------------------------------------------

KEYS = [f"im{i}" for i in range(5)]        # 5 keys: the sampler pads to 6
CAPS = ["a dog runs on the grass", "a cat sits on a red mat",
        "a man walks down the street", "a bird flies over the water",
        "a car drives on the road"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    import base64
    import io
    import shutil
    from PIL import Image
    root = str(tmp_path_factory.mktemp("dp_data"))
    d = os.path.join(root, "data", "tinycoco")
    rng = np.random.RandomState(0)

    def b64():
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 255, (40, 48, 3), dtype=np.uint8)
                        ).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()
    for split in ("train", "test"):
        tsv_writer(((k, "0", b64()) for k in KEYS), f"{d}/{split}.tsv")
        tsv_writer(((k, json.dumps([{"height": 40, "width": 48}]))
                    for k in KEYS), f"{d}/{split}.hw.tsv")
        tsv_writer(((k, json.dumps([{"caption": CAPS[i]},
                                    {"caption": CAPS[(i + 1) % 5]}]))
                    for i, k in enumerate(KEYS)), f"{d}/{split}.caption.tsv")
        tsv_writer(((k, "2") for k in KEYS), f"{d}/{split}.num_caption.tsv")
        tsv_writer(((k, json.dumps([{"class": "dog", "conf": 0.9}]))
                    for k in KEYS), f"{d}/{split}.label.tsv")
    enc = os.path.join(root, "tiny_encoder")
    os.makedirs(enc)
    with open(os.path.join(enc, "config.json"), "w") as f:
        json.dump({"hidden_size": 32, "num_attention_heads": 4,
                   "intermediate_size": 64, "num_hidden_layers": 2,
                   "max_position_embeddings": 96, "type_vocab_size": 2,
                   "vocab_size": 30522, "layer_norm_eps": 1e-12,
                   "attention_probs_dropout_prob": 0.0}, f)
    shutil.copy(DEFAULT_VOCAB, enc)
    return root


def _param(root, output, **kw):
    p = {
        "data": "tinycoco", "test_data": "tinycoco", "test_split": "test",
        "net": "tiny", "expid": "dp",
        "data_root": os.path.join(root, "data"),
        "output_root": output,
        "text_encoder_type": os.path.join(root, "tiny_encoder"),
        "train_crop_size": 32, "test_crop_size": 32,
        "max_seq_length": 26, "max_seq_a_length": 6, "max_gen_length": 6,
        "topk": 5, "split_blocks": 1, "decoder_layers": 2,
        "effective_batch_size": 4, "test_batch_size": 2,
        "max_iter": 3, "snapshot_steps": 2, "log_step": 1,
        "base_lr": 1e-3, "drop_out": 0.0, "num_workers": 1,
        "encode": "bert", "tag_loss_weight": 1.0,
        "compute_dtype": "float32", "device": "cpu",
        "pipeline_type": {
            "from": "src.pipelines.tagger_caption_uni_pipeline_expanding"
                    "_bertemb",
            "import": "CaptionUniPipeline"},
    }
    p.update(kw)
    return p


def _rows(path):
    return [(k, json.loads(v)[0]["caption"]) for k, v in tsv_reader(path)]


def test_two_rank_cli_run_merges_predict_shards(data_root, tmp_path):
    """python -m torch.distributed.run --nproc_per_node 2 -m
    vitcap_tpu_torch.run: 3 data-parallel steps, predict over 5 keys (the
    sampler duplicates one), rank 0's merge and evaluation.  The merged
    TSV holds each key once in dataset order, equals a 1-rank predict
    from the same snapshot row for row, and no shard is left."""
    import yaml
    param = _param(data_root, str(tmp_path / "output"))
    cfg_file = tmp_path / "dp.yaml"
    cfg_file.write_text(yaml.safe_dump({
        "type": "pipeline_train_eval_multi",
        "all_test_data": [{"test_data": "tinycoco", "test_split": "test"}],
        "param": param}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "vitcap_tpu_torch.run", "-c",
         str(cfg_file)], env=_child_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    (rc, out), = _wait([proc])
    assert rc == 0, out[-4000:]

    snap = tmp_path / "output" / "tinycoco_tiny_dp" / "snapshot"
    final = snap / "model_iter_0000003.ckpt"
    assert final.is_file()
    assert torch.load(final, weights_only=True)["opt"]["step"] == 3
    preds = sorted(snap.glob("*.predict.tsv"))
    assert len(preds) == 1, sorted(p.name for p in snap.iterdir())
    rows = _rows(preds[0])
    assert [k for k, _ in rows] == KEYS
    assert not list(snap.glob("*predict.tsv_*_*.tsv"))
    assert not list(snap.glob("*.before.reorder.tsv"))
    assert len(list(snap.glob("*.report"))) == 1
    assert len(list(snap.glob("*.predict.tsv_*_2.tsv.speed.yaml"))) == 2

    pip = TR.create_pipeline(dict(param, expid="dp_one"))
    one = str(tmp_path / "one.predict.tsv")
    pip.predict(str(final), one)
    assert _rows(one) == rows


def test_preemption_stops_every_rank_at_one_sync_iteration(data_root,
                                                           tmp_path):
    """Rank 1 alone gets SIGTERM during step 2; preempt_sync_steps 3: both
    ranks stop after step 3, rank 0 writes that snapshot, both exit 143."""
    param = _param(data_root, str(tmp_path / "output"), expid="preempt",
                   max_iter=8, snapshot_steps=100, preempt_sync_steps=3)
    (tmp_path / "param.json").write_text(json.dumps(param))
    outs = _spawn("preempt", tmp_path, ok=(143,))
    snap = tmp_path / "output" / "tinycoco_tiny_preempt" / "snapshot"
    assert sorted(p.name for p in snap.glob("*.ckpt")) == [
        "model_iter_0000003.ckpt"], outs[0][1][-3000:]
    assert (snap / "last_checkpoint").read_text().endswith(
        "model_iter_0000003.ckpt")
    ck = torch.load(snap / "model_iter_0000003.ckpt", weights_only=True)
    assert ck["iteration"] == 3 and ck["opt"]["step"] == 3
    for rank, (_, out) in enumerate(outs):
        assert f"rank {rank} steps 3" in out, out[-3000:]


def _run_preempt(rank, world, workdir):
    from vitcap_tpu_torch.pipelines import caption_pipeline as TCP
    with open(os.path.join(workdir, "param.json")) as f:
        param = json.load(f)
    make = TT.make_train_step
    steps = [0]

    def make_counting(*a, **kw):
        fn = make(*a, **kw)

        def step(*sa, **skw):
            steps[0] += 1
            if rank == 1 and steps[0] == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return fn(*sa, **skw)
        return step
    TT.make_train_step = make_counting
    pip = TR.create_pipeline(param)
    assert isinstance(pip, TCP.CaptionUniPipeline)
    try:
        pip.ensure_train()
    finally:
        print(f"rank {rank} steps {steps[0]}", flush=True)
        TD.shutdown()


def _worker(mode, rank, world, port, workdir):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(2)
    if mode == "preempt":
        return _run_preempt(rank, world, workdir)
    TD.ensure_init_distributed(device="cpu")
    try:
        {"step": _run_step, "scst": _run_scst}[mode](rank, world, workdir)
    finally:
        TD.shutdown()


if __name__ == "__main__":
    m, r, w, p, d = sys.argv[1:6]
    _worker(m, int(r), int(w), p, d)
