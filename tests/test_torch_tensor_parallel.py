"""vitcap_tpu_torch's Megatron tensor parallelism (parallel/mesh.py
make_mesh, param_partition_specs, shard_params, gather_params;
parallel/tensor_parallel.py) on the CPU, at tiny_config (4 heads) in f32.

The multi-rank cases spawn real peer processes over Gloo (this file run
as a script: `python tests/test_torch_tensor_parallel.py <mode> <rank>
<world> <port> <dir>`), each with a timeout of its own, and compare what
they write with runs in this process:
- 'grid', 4 ranks on a (2, 2) grid: one train step against the JAX
  package's tensor-parallel step (make_mesh(4, 2) on conftest's 8 virtual
  devices) from the same weights, at dropout 0: loss rtol 1e-5, every
  gathered leaf rtol 2e-4 / atol 1e-6 (tests/test_solver.py:162's bound);
- 'tp', 2 ranks on a (1, 2) grid, against the unsplit port: the round
  trip gather_params(shard_params(m)) bit for bit; one train step with
  hidden and attention dropout 0.1 on the generator route (the tiny
  decoder's 22 tokens) and on the counter-hash route (128-px images:
  65-token trunk, 82-token decoder, the split train blocks) and with
  train_fused_blocks (the trunk's fused_vit_block_train), at the same
  bounds; the snapshot of the split run loaded into an unsplit model, and
  loaded back into a split one, and written as msgpack too; greedy and
  beam-3 on both engines (the tokens equal, the first step's logits
  within 1e-5 of their scale), with the int8 context cache, and the token filter's decode (every head's CLS
  scores gathered); the SCST gradient step; the sparse constrained beam
  search; a ViT block and a BERT layer past 1024 tokens: the fused
  inference blocks, and the plain chain (the packed attention, K8
  non-slab, with dropout) forward and gradients.
In this process: the partition specs against the JAX package's _leaf_spec,
the grid's errors, n_model 1 against no grid (the same bits), and the
attention dropout's keep bits at a head offset (the global mask's slice).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from vitcap_tpu_torch.models import config as TC             # noqa: E402
from vitcap_tpu_torch.models import decode as TDec           # noqa: E402
from vitcap_tpu_torch.models import layers as TL             # noqa: E402
from vitcap_tpu_torch.models import vitcap as TM             # noqa: E402
from vitcap_tpu_torch.ops import attention as TA             # noqa: E402
from vitcap_tpu_torch.ops import dropout as TDrop            # noqa: E402
from vitcap_tpu_torch.parallel import distributed as TD      # noqa: E402
from vitcap_tpu_torch.parallel import mesh as TMesh          # noqa: E402
from vitcap_tpu_torch.solver import checkpoint_bridge as TB  # noqa: E402
from vitcap_tpu_torch.solver import checkpointing as TCk     # noqa: E402
from vitcap_tpu_torch.solver import train_step as TT         # noqa: E402

TIMEOUT = 240                 # seconds a spawned run may take
B = 8                         # rows of the train-step batch
HYPER = dict(base_lr=1e-3, max_iter=10)
KW = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
          tag_loss_weight=1.0)
DROP = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
            tag_loss_weight=1.0)
# the dropout runs: the tiny decoder's 22 tokens take the plain chain with
# the generator's masks; 128-px images (65 trunk tokens, an 82-token
# decoder) the split train blocks with the counter hash; with
# train_fused_blocks the trunk's inference blocks and their recomputing
# backward (fused_vit_block_train)
ROUTES = {"generator": dict(DROP), "hash": dict(DROP, img_size=128),
          "fused": dict(DROP, img_size=128, train_fused_blocks=True)}
# decoding 64-px images (a resized pos-embed) with the attention-aware
# token filter before trunk block 1 (CLS scores of every head, gathered)
FILTER = dict(KW, img_size=64, token_filter_keep=0.5, token_filter_block=1)
# the eager engine's int8 context cache (per image and head)
DECODE_CASES = {"decode": KW, "filter": FILTER,
                "int8": dict(KW, kv_cache_quant="int8")}
SEED = 5                      # the train generator's seed
LONG = 1040                   # tokens of the plain-chain block calls
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(mode, workdir, world):
    """This file as a worker, one process a rank; each must exit 0."""
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         port, str(workdir)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
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
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} exited {rc}:\n{out[-4000:]}"


# ---------------------------------------------------------------------------
# inputs, shared by this process and the workers
# ---------------------------------------------------------------------------

def _batch(cfg, seed=3):
    """An 8-row train batch whose halves mask 1 and 3 tokens a row."""
    rs = np.random.RandomState(seed)
    T, A = cfg.max_seq_len, cfg.max_seq_a_len
    masked_pos = np.zeros((B, T), np.int32)
    masked_pos[:B // 2, 2] = 1
    masked_pos[B // 2:, [1, 3, 4]] = 1
    label = (rs.rand(B, cfg.tag_vocab_size) < 0.05).astype(np.float32)
    label[:, 5] = 1.0
    return {
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


def _torch(batch):
    return {k: (torch.from_numpy(np.asarray(v)).long()
                if np.asarray(v).dtype == np.int32
                else torch.from_numpy(np.asarray(v)))
            for k, v in batch.items()}


def _weights(cfg, seed):
    """Seeded port weights with non-zero biases (so they are tested)."""
    model = TM.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    return model.state_dict()


def _model(cfg, sd):
    model = TM.ViTCAP(cfg)
    model.load_state_dict(sd)
    return model.requires_grad_(False)


def _step(model, cfg, batch, generator=None):
    """One train step -> (params by name, metrics as floats)."""
    state = TT.init_train_state(model, generator)
    state, m = TT.make_train_step(cfg, TT.TrainHyper(**HYPER))(
        state, _torch(batch))
    return state, {k: float(v) for k, v in m.items()}


def _decode_inputs(cfg):
    rs = np.random.RandomState(11)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    return (torch.from_numpy(rs.randint(0, 256, (2, cfg.img_size,
                                                 cfg.img_size, 3))
                             .astype(np.uint8)),
            torch.from_numpy(rs.randint(1, cfg.vocab_size, (2, od_len)))
            .long(), None,
            torch.tensor([cfg.max_seq_len, cfg.max_seq_a_len + 3]))


def _decode(model, cfg):
    """Greedy and beam-3 on both engines: ids, logprobs, and the first
    step's f32 logits."""
    opts = TDec.DecodeOptions(max_length=cfg.max_gen_length,
                              od_labels_start_posid=cfg.max_seq_a_len)
    beam = TDec.DecodeOptions(max_length=cfg.max_gen_length,
                              od_labels_start_posid=cfg.max_seq_a_len,
                              num_beams=3)
    inputs = _decode_inputs(cfg)
    out = {}
    old = os.environ.get("VITCAP_DECODE_FUSED")
    try:
        for engine, flag in (("eager", "0"), ("fused", "1")):
            os.environ["VITCAP_DECODE_FUSED"] = flag
            g = TDec.generate_greedy(model, *inputs, cfg, opts)
            b = TDec.generate_beam(model, *inputs, cfg, beam)
            with torch.inference_mode():
                ctx = TDec.build_decode_context(model, *inputs, cfg, opts)
                init, step, _ = TDec._decode_engine(model, ctx, cfg, opts, 2)
                logits, _ = step(init(), torch.full((2,), cfg.cls_token_id),
                                 1)
            out.update({f"{engine}_greedy": g["ids"],
                        f"{engine}_greedy_lp": g["logprobs"],
                        f"{engine}_beam": b["ids"],
                        f"{engine}_beam_lp": b["logprobs"],
                        f"{engine}_logits": logits.clone()})
    finally:
        if old is None:
            os.environ.pop("VITCAP_DECODE_FUSED", None)
        else:
            os.environ["VITCAP_DECODE_FUSED"] = old
    return out


def _scst(model, cfg):
    """The SCST gradient step on fixed samples -> metrics."""
    from vitcap_tpu_torch.solver import scst as TS
    rs = np.random.RandomState(7)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    A = cfg.max_gen_length
    batch = {"image": torch.from_numpy(
                 rs.randint(0, 256, (2, cfg.img_size, cfg.img_size, 3))
                 .astype(np.uint8)),
             "od_ids": torch.from_numpy(
                 rs.randint(1, cfg.vocab_size, (2, od_len))).long(),
             "seq_len": torch.tensor([cfg.max_seq_len, cfg.max_seq_len - 3])}
    ids = rs.randint(1, cfg.vocab_size, (4, A))
    ids[:, 0] = cfg.cls_token_id
    ids[ids == cfg.sep_token_id] = 7
    ids[1, 3], ids[1, 4:] = cfg.sep_token_id, cfg.pad_token_id
    ids = torch.from_numpy(ids).long()
    opts = TDec.DecodeOptions(max_length=A,
                              od_labels_start_posid=cfg.max_seq_a_len)
    _, grad = TS.make_scst_fns(cfg, opts, TS.ScstConfig(num_return=2),
                               TT.TrainHyper(**HYPER))
    state = TT.init_train_state(model, None)
    state, m = grad(state, batch, ids, ids[:, 1:],
                    torch.from_numpy(rs.randn(4).astype(np.float32)),
                    torch.zeros((2, 0), dtype=torch.long))
    return {k: float(v) for k, v in m.items()}


C2T = {"dog": ["dog"], "cat": ["cat"], "fire": ["fire"],
       "hydrant": ["hydrant"]}
WF = {"dog": ["dog", "dogs"], "cat": ["cat", "cats"], "fire": ["fire"],
      "hydrant": ["hydrant"]}


def _cbs(model, cfg):
    """The sparse constrained beam search (3 beams) -> ids, logprobs."""
    from vitcap_tpu_torch.data.tokenization import (DEFAULT_VOCAB,
                                                    BertTokenizer)
    from vitcap_tpu_torch.models import cbs as TCbs
    builder = TCbs.FiniteStateMachineBuilder(
        BertTokenizer(str(DEFAULT_VOCAB)), C2T, WF, max_given_constraints=2)
    sfsm = TCbs.sparse_batch([TCbs.build_sparse_fsm(builder, c)
                              for c in (["fire hydrant", "dog"], ["cat"])])
    opts = TDec.DecodeOptions(max_length=cfg.max_gen_length,
                              od_labels_start_posid=cfg.max_seq_a_len)
    got = TCbs.constrained_beam_search_sparse(
        model, *_decode_inputs(cfg),
        {k: TCbs.put(v, "cpu") for k, v in sfsm.items()}, cfg, opts,
        beam_size=3)
    return {"cbs_ids": got["ids"], "cbs_lp": got["logprobs"]}


def _long_inputs(cfg):
    rs = np.random.RandomState(13)
    x = torch.from_numpy(rs.randn(1, LONG, cfg.hidden_size)
                         .astype(np.float32))
    mask = np.zeros((1, 1, LONG, LONG), np.float32)
    mask[..., LONG - 9:] = TL.NEG_MASK_VALUE          # masked keys
    return x, torch.from_numpy(mask)


def _long_blocks(model, cfg):
    """Trunk block 0 and decoder layer 0 over LONG tokens (past 1024): as
    inference calls (the fused blocks, K10's composition) and as train
    calls (the plain chain, the packed attention), the BERT layer with
    dropout 0.1 from seeds -> outputs, input gradients and the gradients
    of the model's parameters."""
    x, mask = _long_inputs(cfg)
    nh = cfg.num_attention_heads
    with torch.no_grad():
        out = {"vit_inf": TL.vit_block(model.bert.encoder.blocks[0], x, nh,
                                       cfg.vit_layer_norm_eps),
               "bert_inf": TL.bert_layer(model.bert.decoder.layer[0], x,
                                         mask, nh, cfg.bert_layer_norm_eps)}
    model.requires_grad_(True)
    for name, fn in (
            ("vit", lambda x: TL.vit_block(model.bert.encoder.blocks[0], x,
                                           cfg.num_attention_heads,
                                           cfg.vit_layer_norm_eps)),
            ("bert", lambda x: TL.bert_layer(
                model.bert.decoder.layer[0], x, mask,
                cfg.num_attention_heads, cfg.bert_layer_norm_eps,
                hidden_dropout=0.1, attn_dropout=0.1, seeds=(3, -4)))):
        for p in model.parameters():
            p.grad = None
        xi = x.clone().requires_grad_(True)
        y = fn(xi)
        (y * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum().backward()
        out[f"{name}_out"] = y.detach()
        out[f"{name}_dx"] = xi.grad
        out[f"{name}_grads"] = {n: p.grad.clone() for n, p in
                                model.named_parameters()
                                if p.grad is not None}
    model.requires_grad_(False)
    return out


# ---------------------------------------------------------------------------
# the workers
# ---------------------------------------------------------------------------

def _run_grid(rank, world, workdir):
    cfg = TC.tiny_config(**KW)
    mesh = TMesh.make_mesh(2, 2, cfg)
    assert (mesh.data_rank, mesh.model_rank) == (rank // 2, rank % 2)
    model = _model(cfg, torch.load(os.path.join(workdir, "grid.pt")))
    TMesh.shard_params(model, mesh, tensor_parallel=True)
    batch = TMesh.local_rows(dict(np.load(os.path.join(workdir,
                                                       "grid.npz"))))
    state, m = _step(model, cfg, batch)
    full = TMesh.gather_params(model)
    if mesh.model_rank == 0:
        torch.save({"params": full, "metrics": m},
                   os.path.join(workdir, f"grid_{mesh.data_rank}.pt"))


def _run_tp(rank, world, workdir):
    mesh = TMesh.make_mesh(1, 2)
    out = {}
    # the round trip, and the shard's shapes
    cfg = TC.tiny_config(**KW)
    sd = torch.load(os.path.join(workdir, "tiny.pt"))
    model = _model(cfg, sd)
    TMesh.shard_params(model, mesh, tensor_parallel=True)
    out["gathered"] = TMesh.gather_params(model)
    out["local_shapes"] = {n: tuple(p.shape)
                           for n, p in model.named_parameters()}
    for case, kw in DECODE_CASES.items():
        out[case] = _decode(model, TC.tiny_config(**kw))
    vcfg = TC.tiny_config(vocab_size=30522, **KW)
    out["cbs"] = _cbs(TMesh.shard_params(
        _model(vcfg, torch.load(os.path.join(workdir, "vocab.pt"))), mesh,
        tensor_parallel=True), vcfg)
    out["long"] = _long_blocks(model, cfg)
    out["long"]["vit_grads"] = TMesh.gather_state(model,
                                                  out["long"]["vit_grads"])
    out["long"]["bert_grads"] = TMesh.gather_state(model,
                                                   out["long"]["bert_grads"])
    out["scst"] = _scst(model, cfg)
    out["scst_params"] = TMesh.gather_params(model)
    # a train step with dropout on each route; its snapshot
    for route, kw in ROUTES.items():
        cfg = TC.tiny_config(**kw)
        model = _model(cfg, torch.load(os.path.join(workdir, f"{route}.pt")))
        TMesh.shard_params(model, mesh, tensor_parallel=True)
        gen = torch.Generator().manual_seed(TMesh.rank_seed(SEED))
        state, m = _step(model, cfg, _batch(cfg), gen)
        snap = TCk.snapshot(state, 1)
        out[route] = {"params": TMesh.gather_params(model), "metrics": m}
        if route == "hash":
            if rank == 0:
                TCk.save_state(os.path.join(workdir, "tp_snap.ckpt"), snap)
                TCk.save_state(os.path.join(workdir, "tp_snap_mp.ckpt"),
                               snap, "msgpack")
            # the unsplit file back into a split model
            back = _model(cfg, torch.load(os.path.join(workdir,
                                                       f"{route}.pt")))
            TMesh.shard_params(back, mesh, tensor_parallel=True)
            st = TCk.restore_train_state(snap, back)
            out["reloaded"] = TMesh.gather_params(back)
            out["reloaded_mu"] = TMesh.gather_state(back, st.opt.mu)
    torch.save(out, os.path.join(workdir, f"tp_{rank}.pt"))


MODES = {"grid": _run_grid, "tp": _run_tp}


def _worker(mode, rank, world, port, workdir):
    torch.set_num_threads(1)
    TD.ensure_init_distributed(f"127.0.0.1:{port}", world, rank,
                               device="cpu")
    try:
        MODES[mode](rank, world, workdir)
    finally:
        TD.shutdown()


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def _close(got, want, what, rtol=2e-4, atol=1e-6):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               want.detach().float().numpy(), rtol=rtol,
                               atol=atol, err_msg=what)


def _close_params(got, want, what):
    assert got.keys() == want.keys(), what
    for n in want:
        _close(got[n], want[n], f"{what}: {n}")


def test_partition_specs_mark_the_jax_leaves():
    """Every leaf the JAX package's _leaf_spec splits is split here along
    the same axis (in the torch layout), and nothing else."""
    import jax
    from jax.sharding import PartitionSpec as P
    from vitcap_tpu.models import vitcap as JM
    from vitcap_tpu.models.config import tiny_config as jax_tiny_config
    from vitcap_tpu.parallel import mesh as JMesh
    class Leaf:                      # a spec that flatten_params keeps whole
        def __init__(self, spec):
            self.spec = tuple(spec)

    params = JM.init_params(jax.random.PRNGKey(0), jax_tiny_config())
    jspecs = TB.flatten_params(jax.tree_util.tree_map(
        Leaf, JMesh.param_partition_specs(params),
        is_leaf=lambda x: isinstance(x, P)))
    model = TM.ViTCAP(TC.tiny_config(), device="meta")
    specs = TMesh.param_partition_specs(model)
    torch_of = {}
    for path, leaf in jspecs.items():
        name, transform = TB.jax_path_to_torch_name(path)
        spec = leaf.spec
        torch_of[name] = spec if transform != "linear_t" \
            else tuple(reversed(spec + (None,) * (2 - len(spec))))
    assert set(torch_of) == set(specs)
    n_split = 0
    for name, spec in specs.items():
        want = tuple(torch_of[name])
        want = () if all(a is None for a in want) else want
        assert spec == want, (name, spec, want)
        n_split += bool(spec)
    # per block: qkv + bias, proj, fc1 + bias, fc2 (6 trunk blocks);
    # q, k, v + biases, out-dense, fc1 + bias, fc2 (2 decoder layers)
    assert n_split == 6 * 6 + 2 * 10


def test_grid_and_head_errors():
    cfg = TC.tiny_config()
    with pytest.raises(ValueError, match="needs 4 processes"):
        TMesh.make_mesh(2, 2)
    with pytest.raises(ValueError, match="does not divide the world's 1"):
        TMesh.make_mesh(None, 2)
    assert TMesh.make_mesh(1, 1, cfg).shape == {"data": 1, "model": 1}
    for n in (3, 8):
        with pytest.raises(ValueError, match="must divide the 4 attention"):
            TMesh.check_model_axis(n, cfg.num_attention_heads,
                                   cfg.intermediate_size)
        grid = TMesh.Mesh(1, n, 0, 0, None, None)
        with pytest.raises(ValueError, match="must divide the 4 attention"):
            TMesh.shard_params(TM.ViTCAP(cfg, device="meta"), grid,
                               tensor_parallel=True)
    TMesh.check_model_axis(2, 12, 3072)
    with pytest.raises(ValueError, match="MLP width 3071"):
        TMesh.check_model_axis(2, 12, 3071)


def test_n_model_one_is_the_unsplit_model():
    """A (1, 1) grid with tensor_parallel=True splits nothing and records
    no shard: its train step gives the bits of a model on no grid."""
    cfg = TC.tiny_config(**ROUTES["hash"])
    sd = _weights(cfg, 21)
    batch = _batch(cfg)
    a = _model(cfg, sd)
    b = TMesh.shard_params(_model(cfg, sd), TMesh.make_mesh(1, 1),
                           tensor_parallel=True)
    assert TMesh.sharded_names(b) == []
    assert all(TL.tp_of(m) is None for m in b.modules())
    _, ma = _step(a, cfg, batch, torch.Generator().manual_seed(SEED))
    _, mb = _step(b, cfg, batch, torch.Generator().manual_seed(SEED))
    assert ma == mb
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("nh, off, total", [(4, 0, 4), (2, 0, 4), (2, 2, 4),
                                            (3, 9, 12), (1, 5, 6)])
def test_attention_keep_at_a_head_offset(nh, off, total):
    """The keep bits of heads [off, off + nh) of `total` are the global
    mask's slice; the plain attention and its backward at that offset are
    the global ones' heads."""
    B, Lp, hd = 2, 24, 8
    glob = TDrop.attention_keep(77, 0.3, B, total, Lp)
    part = TDrop.attention_keep(77, 0.3, B, nh, Lp, nh_total=total,
                                head_offset=off)
    assert torch.equal(part, glob[:, off:off + nh])
    assert torch.equal(TDrop.attention_keep(77, 0.3, B, total, Lp,
                                            nh_total=total), glob)
    g = torch.Generator().manual_seed(nh * 100 + off)
    q, k, v, dout = (torch.randn(B, total, Lp, hd, generator=g)
                     for _ in range(4))
    full = TA.attention_heads_plain(q, k, v, Lp - 3, rate=0.3, seed=77)
    sl = slice(off, off + nh)
    mine = TA.attention_heads_plain(q[:, sl], k[:, sl], v[:, sl], Lp - 3,
                                    rate=0.3, seed=77, nh_total=total,
                                    head_offset=off)
    assert torch.equal(mine, full[:, sl])
    from vitcap_tpu_torch.ops import attention_bwd as TAB
    gf = TAB.attention_bwd_heads_plain(q, k, v, dout, Lp - 3, rate=0.3,
                                       seed=77)
    gm = TAB.attention_bwd_heads_plain(q[:, sl], k[:, sl], v[:, sl],
                                       dout[:, sl], Lp - 3, rate=0.3,
                                       seed=77, nh_total=total,
                                       head_offset=off)
    for a, b in zip(gm, gf):
        assert torch.equal(a, b[:, sl])
    with pytest.raises(ValueError, match="outside the"):
        TDrop.attention_keep(77, 0.3, B, nh, Lp, nh_total=total,
                             head_offset=total - nh + 1)


def test_generator_dropout_draws_the_global_heads():
    """layers.dropout over a head slice keeps the unsplit draw's slice and
    advances the generator as the unsplit draw does."""
    x = torch.randn(2, 6, 5, 7)
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    full = TL.dropout(x, 0.4, g1)
    part = TL.dropout(x[:, 2:4], 0.4, g2, heads=(6, 2))
    assert torch.equal(part, full[:, 2:4])
    assert torch.equal(torch.rand(3, generator=g1), torch.rand(3,
                                                               generator=g2))


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    """The (2, 2) grid's step from the JAX tiny model's weights."""
    import jax
    from vitcap_tpu.models import vitcap as JM
    from vitcap_tpu.models.config import tiny_config as jax_tiny_config
    d = tmp_path_factory.mktemp("tp_grid")
    jcfg = jax_tiny_config(**KW)
    params = jax.tree_util.tree_map(
        np.array, JM.init_params(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(3)
    for path, a in TB.flatten_params(params).items():
        if path.endswith("bias"):
            a[...] = rs.randn(*a.shape).astype(np.float32) * 0.02
    model = TB.load_jax_params(TM.ViTCAP(TC.tiny_config(**KW)), params)
    torch.save(model.state_dict(), d / "grid.pt")
    batch = _batch(TC.tiny_config(**KW))
    np.savez(d / "grid.npz", **batch)
    _spawn("grid", d, 4)
    return params, batch, [torch.load(d / f"grid_{r}.pt") for r in range(2)]


def test_grid_step_matches_the_jax_tensor_parallel_step(grid_run):
    import jax
    import jax.numpy as jnp
    from vitcap_tpu.models.config import tiny_config as jax_tiny_config
    from vitcap_tpu.parallel import mesh as JMesh
    from vitcap_tpu.solver import train_step as JT
    params, batch, got = grid_run
    mesh = JMesh.make_mesh(n_data=4, n_model=2)
    st = JT.init_train_state(
        JMesh.shard_params(jax.tree_util.tree_map(jnp.asarray, params),
                           mesh, tensor_parallel=True),
        jax.random.PRNGKey(1))
    st, jm = JT.make_jitted_train_step(jax_tiny_config(**KW),
                                       JT.TrainHyper(**HYPER), mesh)(
        st, JMesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              mesh))
    np.testing.assert_allclose(got[0]["metrics"]["loss"], float(jm["loss"]),
                               rtol=1e-5)
    ref = TB.flatten_params(jax.tree_util.tree_map(np.asarray, st.params))
    for r in range(2):
        flat = TB.state_to_jax_flat(got[r]["params"])
        assert flat.keys() == ref.keys()
        for path, want in ref.items():
            np.testing.assert_allclose(flat[path], want, rtol=2e-4,
                                       atol=1e-6, err_msg=path)
    for n, t in got[0]["params"].items():      # the data ranks agree
        assert torch.equal(t, got[1]["params"][n]), n


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_pair")
    cfg = TC.tiny_config(**KW)
    sds = {"tiny": _weights(cfg, 31),
           "vocab": _weights(TC.tiny_config(vocab_size=30522, **KW), 32)}
    for route, kw in ROUTES.items():
        sds[route] = _weights(TC.tiny_config(**kw), 33)
    for name, sd in sds.items():
        torch.save(sd, d / f"{name}.pt")
    _spawn("tp", d, 2)
    return d, sds, [torch.load(d / f"tp_{r}.pt") for r in range(2)]


def test_split_round_trip_is_bit_exact(tp_run):
    d, sds, got = tp_run
    cfg = TC.tiny_config(**KW)
    for r in range(2):
        assert got[r]["gathered"].keys() == sds["tiny"].keys()
        for n, t in sds["tiny"].items():
            g = got[r]["gathered"][n]
            assert g.dtype == t.dtype and torch.equal(
                g.view(torch.int32), t.view(torch.int32)), n
    shapes = got[0]["local_shapes"]
    H, I = cfg.hidden_size, cfg.intermediate_size
    blk = "bert.encoder.blocks.0."
    assert shapes[blk + "attn.qkv.weight"] == (3 * H // 2, H)
    assert shapes[blk + "attn.qkv.bias"] == (3 * H // 2,)
    assert shapes[blk + "attn.proj.weight"] == (H, H // 2)
    assert shapes[blk + "attn.proj.bias"] == (H,)
    assert shapes[blk + "mlp.fc2.weight"] == (H, I // 2)
    lay = "bert.decoder.layer.1."
    assert shapes[lay + "attention.self.key.weight"] == (H // 2, H)
    assert shapes[lay + "output.dense.weight"] == (H, I // 2)
    assert shapes[lay + "output.LayerNorm.weight"] == (H,)
    assert shapes["cls.predictions.bias"] == (cfg.vocab_size,)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_split_step_with_dropout_matches_the_unsplit_port(tp_run, route):
    d, sds, got = tp_run
    cfg = TC.tiny_config(**ROUTES[route])
    model = _model(cfg, sds[route])
    _, m = _step(model, cfg, _batch(cfg),
                 torch.Generator().manual_seed(SEED))
    want = {n: p.detach() for n, p in model.named_parameters()}
    for r in range(2):
        np.testing.assert_allclose(got[r][route]["metrics"]["loss"],
                                   m["loss"], rtol=1e-5)
        _close_params(got[r][route]["params"], want, route)
    if route == "hash":
        # the split run's snapshot is the unsplit layout: it loads into an
        # unsplit model, and (in the workers) back into a split one
        snap = TCk.load_state(str(d / "tp_snap.ckpt"))
        back = _model(cfg, sds[route])
        st = TCk.restore_train_state(snap, back)
        _close_params({n: p for n, p in back.named_parameters()}, want,
                      "snapshot")
        for r in range(2):
            for n, t in snap["model"].items():
                assert torch.equal(got[r]["reloaded"][n], t), n
            for n, t in snap["opt"]["mu"].items():
                assert torch.equal(got[r]["reloaded_mu"][n], t), n
                assert st.opt.mu[n].shape == t.shape


def test_split_snapshot_in_msgpack(tp_run):
    """The split run's gathered snapshot written with backend 'msgpack'
    loads as the torch one: weights, both moments, step, iteration and
    the generator's state, bit for bit."""
    d, _, _ = tp_run
    mp = TCk.load_state(str(d / "tp_snap_mp.ckpt"))
    pt = TCk.load_state(str(d / "tp_snap.ckpt"))
    assert not TCk.is_torch_file(str(d / "tp_snap_mp.ckpt"))
    assert mp["iteration"] == pt["iteration"] == 1
    assert mp["opt"]["step"] == pt["opt"]["step"] == 1
    assert torch.equal(mp["generator"], pt["generator"])
    for key, a, b in (("model", mp["model"], pt["model"]),
                      ("mu", mp["opt"]["mu"], pt["opt"]["mu"]),
                      ("nu", mp["opt"]["nu"], pt["opt"]["nu"])):
        assert a.keys() == b.keys(), key
        for n in b:
            assert torch.equal(a[n], b[n]), (key, n)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_split_decode_gives_the_unsplit_tokens(tp_run, case):
    d, sds, got = tp_run
    want = _decode(_model(TC.tiny_config(**KW), sds["tiny"]),
                   TC.tiny_config(**DECODE_CASES[case]))
    for r in range(2):
        mine = got[r][case]
        for key, w in want.items():
            if key.endswith(("greedy", "beam")):
                assert torch.equal(mine[key], w), (r, key)
            elif key.endswith("logits"):
                scale = w.abs().max()
                assert (mine[key] - w).abs().max() <= 1e-5 * scale, key
            else:
                _close(mine[key], w, key, rtol=1e-5, atol=1e-6)



def test_split_constrained_beam_search(tp_run):
    d, sds, got = tp_run
    vcfg = TC.tiny_config(vocab_size=30522, **KW)
    want = _cbs(_model(vcfg, sds["vocab"]), vcfg)
    for r in range(2):
        assert torch.equal(got[r]["cbs"]["cbs_ids"], want["cbs_ids"])
        _close(got[r]["cbs"]["cbs_lp"], want["cbs_lp"], "cbs", rtol=0,
               atol=1e-5)


def test_split_scst_step_matches_the_unsplit_port(tp_run):
    d, sds, got = tp_run
    cfg = TC.tiny_config(**KW)
    model = _model(cfg, sds["tiny"])
    m = _scst(model, cfg)
    want = {n: p.detach() for n, p in model.named_parameters()}
    for r in range(2):
        for key in ("scst_loss", "mean_logprob", "grad_norm"):
            np.testing.assert_allclose(got[r]["scst"][key], m[key],
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        _close_params(got[r]["scst_params"], want, "scst")


def test_split_blocks_past_1024_tokens(tp_run):
    """Past 1024 tokens: the fused inference blocks, and the plain chain's
    packed attention (K8 non-slab) with dropout from seeds, forward and
    backward, split against unsplit."""
    d, sds, got = tp_run
    cfg = TC.tiny_config(**KW)
    want = _long_blocks(_model(cfg, sds["tiny"]), cfg)
    for r in range(2):
        mine = got[r]["long"]
        for name in ("vit_inf", "bert_inf"):
            _close(mine[name], want[name], name, 1e-5)
        for name in ("vit", "bert"):
            _close(mine[f"{name}_out"], want[f"{name}_out"], name, 1e-5)
            _close(mine[f"{name}_dx"], want[f"{name}_dx"], name)
            assert mine[f"{name}_grads"].keys() == \
                want[f"{name}_grads"].keys()
            for n, g in want[f"{name}_grads"].items():
                _close(mine[f"{name}_grads"][n], g, n, atol=1e-5)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            sys.argv[5])
