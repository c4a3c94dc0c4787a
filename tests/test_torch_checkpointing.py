"""vitcap_tpu_torch checkpointing (solver/checkpointing.py) and the `.pt`
direction of its checkpoint bridge (solver/checkpoint_bridge.py), on the
CPU.

Resume is held to an uninterrupted run bit for bit (weights, Adam moments,
the dropout generator's state); the pointer file, its fallback and the
tagged snapshots to the JAX package's Checkpointer semantics; the bridge
(load_params_from_torch, _suffix_match, convert_vit_cls_state_dict_to_
caption, load_torch_state_dict) to the JAX package's bridge on state
dicts that its params_to_torch_state_dict writes; and a JAX snapshot,
carried across, gives the port the JAX package's greedy ids.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.models import decode as JD
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.solver import checkpoint_bridge as JB
from vitcap_tpu.solver import checkpointing as JC

from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import decode as TD
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.solver import checkpoint_bridge as TB
from vitcap_tpu_torch.solver import checkpointing as TCk
from vitcap_tpu_torch.solver import train_step as TT

B = 2
HYPER = TT.TrainHyper(base_lr=1e-3, max_iter=20, warmup_steps=1)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfg():
    return TC.tiny_config(hidden_dropout_prob=0.1,
                          attention_probs_dropout_prob=0.1,
                          tag_loss_weight=1.0)


def _batch(cfg, seed=0):
    rs = np.random.RandomState(seed)
    T, A = cfg.max_seq_len, cfg.max_seq_a_len
    masked_pos = np.zeros((B, T), np.int64)
    masked_pos[0, [1, 2, 4]] = 1
    masked_pos[1, [3, 5]] = 1
    label = (rs.rand(B, cfg.tag_vocab_size) < 0.05).astype(np.float32)
    label[:, 7] = 1.0
    b = {
        "image": rs.randn(B, cfg.img_size, cfg.img_size, 3)
                 .astype(np.float32),
        "input_ids": rs.randint(1, cfg.vocab_size, (B, T)),
        "token_type_ids": np.concatenate(
            [np.zeros((B, A), np.int64), np.ones((B, T - A), np.int64)], 1),
        "seq_a_len": np.array([A, A - 2]),
        "seq_len": np.array([T, T - 4]),
        "masked_pos": masked_pos,
        "masked_ids": rs.randint(1, cfg.vocab_size,
                                 (B, cfg.max_masked_tokens)),
        "label": label,
    }
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _fresh_state(cfg, seed=0, gen_seed=7):
    model = TM.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return TT.init_train_state(model, torch.Generator().manual_seed(gen_seed))


def _assert_states_equal(a, b):
    for (n, p), (m, q) in zip(a.model.named_parameters(),
                              b.model.named_parameters()):
        assert n == m and torch.equal(p, q), n
    assert a.opt.step == b.opt.step
    for n in a.opt.mu:
        assert torch.equal(a.opt.mu[n], b.opt.mu[n]), n
        assert torch.equal(a.opt.nu[n], b.opt.nu[n]), n
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ---------------------------------------------------------------------------
# save, load and resume
# ---------------------------------------------------------------------------

def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    """Dropout on (its seeds drawn from the state's generator), f32: two
    steps, save, restore into a model initialised otherwise, one step; the
    parameters, both moments, the step and the generator's state equal an
    uninterrupted three-step run's, bit for bit, and so do the third
    step's metrics."""
    cfg = _cfg()
    step = TT.make_train_step(cfg, HYPER)
    batches = [_batch(cfg, seed=i) for i in range(3)]
    ref = _fresh_state(cfg)
    for b in batches:
        ref, ref_m = step(ref, b)
    run = _fresh_state(cfg)
    for b in batches[:2]:
        run, _ = step(run, b)
    ck = TCk.Checkpointer(str(tmp_path))
    path = ck.save(2, run)
    assert path == str(tmp_path / "model_iter_0000002.ckpt")
    assert ck.last_checkpoint() == path
    model, snap, it = ck.recover_or_load(
        None, TM.init_params(cfg, torch.Generator().manual_seed(99), "cpu"))
    assert it == 2 and snap["iteration"] == 2
    resumed = TCk.restore_train_state(snap, model)
    assert resumed.generator is not None
    assert all(p.requires_grad for p in resumed.model.parameters())
    resumed, m = step(resumed, batches[2])
    _assert_states_equal(resumed, ref)
    for k in ("loss", "grad_norm", "masked_loss", "tag_loss"):
        assert torch.equal(m[k], ref_m[k]), k


def test_snapshot_holds_plain_containers(tmp_path):
    """A snapshot reads back with weights_only=True: the state dict, the
    Adam step and moments by name, the generator's state and device, the
    iteration; a state without a generator saves None."""
    cfg = TC.tiny_config()
    state = _fresh_state(cfg)
    state.generator = None
    path = TCk.Checkpointer(str(tmp_path)).save(0, state)
    snap = torch.load(path, weights_only=True)
    assert set(snap) == {"model", "opt", "generator", "generator_device",
                         "iteration"}
    assert snap["generator"] is None and snap["opt"]["step"] == 0
    assert snap["model"].keys() == state.model.state_dict().keys()
    assert snap["opt"]["mu"].keys() == dict(
        state.model.named_parameters()).keys()
    restored = TCk.restore_train_state(snap, TM.init_params(
        cfg, torch.Generator().manual_seed(5), "cpu"))
    assert restored.generator is None
    assert not os.path.exists(path + ".tmp")


def test_pointer_and_its_fallback(tmp_path):
    """The pointer names the newest save; when the file it names is gone,
    the newest model_iter_* snapshot that exists; no pointer, None."""
    ck = TCk.Checkpointer(str(tmp_path))
    assert not ck.has_checkpoint() and ck.last_checkpoint() is None
    state = _fresh_state(TC.tiny_config())
    p1, p3, p2 = (ck.save(i, state) for i in (1, 3, 2))
    assert ck.last_checkpoint() == p2
    with open(ck.pointer_file) as f:
        assert f.read() == p2
    os.remove(p2)
    assert ck.last_checkpoint() == p3
    os.remove(p3)
    os.remove(p1)
    assert ck.has_checkpoint() and ck.last_checkpoint() is None


def test_save_tagged_leaves_the_pointer(tmp_path):
    state = _fresh_state(TC.tiny_config())
    ck = TCk.Checkpointer(str(tmp_path))
    ref = JC.Checkpointer(str(tmp_path / "jax"))
    good = ck.save(4, state)
    tagged = ck.save_tagged("NaN_context_0", 5, state)
    assert os.path.basename(tagged) == "NaN_context_0.ckpt"
    assert os.path.isfile(tagged) and ck.last_checkpoint() == good
    assert torch.load(tagged, weights_only=True)["iteration"] == 5
    # the JAX package's naming and pointer rule, side by side
    jgood = ref.save(4, {"params": {"w": np.zeros(2, np.float32)}})
    ref.save_tagged("NaN_context_0", 5, {"params": {}})
    assert os.path.basename(jgood) == os.path.basename(good)
    assert ref.last_checkpoint() == jgood


def test_jax_only_backends_raise(tmp_path):
    """The JAX package's orbax backend and async saves, which the port
    once refused, are now the port's too (their round trips:
    test_torch_orbax.py); a backend neither package writes raises."""
    ck = TCk.Checkpointer(str(tmp_path), backend="orbax", async_save=True)
    assert ck.async_save and ck.checkpoint_path(3).endswith(
        "model_iter_0000003.orbax")
    assert TCk.BACKENDS == ("torch", "msgpack", "orbax")
    with pytest.raises(ValueError, match="zarr3"):
        TCk.Checkpointer(str(tmp_path), backend="zarr3")


def test_recover_or_load_priority(tmp_path):
    """The last snapshot beats a base model, which beats the model as it
    is; a base model is a reference `.pt` (through the bridge: every
    parameter matched) or a port `.ckpt` (weights only, iteration 0)."""
    cfg = TC.tiny_config()

    def model(seed):
        return TM.init_params(cfg, torch.Generator().manual_seed(seed),
                              "cpu")

    def sd(m):
        return {n: p.detach().clone() for n, p in m.state_dict().items()}
    base_pt, base_ck, snap_m, init = model(1), model(2), model(3), model(4)
    pt = tmp_path / "base.pt"
    torch.save({"model": {"module." + n: t for n, t in sd(base_pt).items()},
                "iteration": 77}, pt)
    ck_path = TCk.Checkpointer(str(tmp_path / "other")).save(
        9, TT.init_train_state(base_ck, None))
    ck = TCk.Checkpointer(str(tmp_path / "run"))

    def same(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(a.state_dict().values(), b.state_dict().values()))
    m, snap, it = ck.recover_or_load(None, model(4))
    assert same(m, init) and snap is None and it == 0
    m, snap, it = ck.recover_or_load(str(pt), model(4))
    assert same(m, base_pt) and snap is None and it == 0
    rep = ck.load_report
    assert len(rep["matched"]) == len(list(m.parameters()))
    assert not rep["missing"] and not rep["shape_mismatch"]
    assert not rep["unused"]
    m, snap, it = ck.recover_or_load(ck_path, model(4))
    assert same(m, base_ck) and snap is None and it == 0
    ck.save(12, TT.init_train_state(snap_m, None))
    m, snap, it = ck.recover_or_load(str(pt), model(4))
    assert same(m, snap_m) and it == 12 and snap["iteration"] == 12


# ---------------------------------------------------------------------------
# the .pt bridge against the JAX package's
# ---------------------------------------------------------------------------

def _jax_params(seed):
    return jax.tree_util.tree_map(
        np.array, JM.init_params(jax.random.PRNGKey(seed), jax_tiny_config()))


def _variants(sd):
    """The JAX exporter's state dict ('module.' on all but the image
    encoder), with the prefixes stripped, with them doubled, and with one
    tensor of another shape plus a key no parameter takes."""
    strip = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in sd.items()}
    double = {"module." + k: v for k, v in sd.items()}
    bad = dict(sd)
    bad["module.cls.predictions.bias"] = np.zeros(3, np.float32)
    bad["module.bert.unused.weight"] = np.ones(2, np.float32)
    return {"as_written": sd, "no_prefix": strip, "double_prefix": double,
            "mismatch": bad}


@pytest.mark.parametrize("variant", ["as_written", "no_prefix",
                                     "double_prefix", "mismatch"])
def test_load_params_from_torch_matches_jax_bridge(variant):
    """The same report (matched, missing, shape-skipped, unused) and the
    same weights as the JAX bridge, whose result is carried across with
    load_jax_params; strict=True raises where a tensor was skipped."""
    src = _jax_params(1)
    sd = _variants(JB.params_to_torch_state_dict(src))[variant]
    jparams, jrep = JB.load_params_from_torch(_jax_params(2), sd)
    ref = TB.load_jax_params(TM.ViTCAP(TC.tiny_config()),
                             jax.tree_util.tree_map(np.asarray, jparams))
    model = TB.load_jax_params(TM.ViTCAP(TC.tiny_config()), _jax_params(2))
    model, rep = TB.load_params_from_torch(
        model, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    dims = {n: p.dim() for n, p in model.named_parameters()}

    def path(n):
        return TB.torch_name_to_jax_path(n, dims[n])[0]
    assert {(path(n), k) for n, k in rep["matched"]} == set(jrep["matched"])
    assert {n for n, _ in rep["missing"]} == {t for _, t in jrep["missing"]}
    assert ({(path(n), k) for n, k, *_ in rep["shape_mismatch"]}
            == {(p, k) for p, k, *_ in jrep["shape_mismatch"]})
    assert rep["unused"] == jrep["unused"]
    assert len(rep["shape_mismatch"]) == (variant == "mismatch")
    assert not rep["missing"]
    for (n, p), (m, q) in zip(model.named_parameters(),
                              ref.named_parameters()):
        assert n == m and torch.equal(p, q), n
    if variant == "mismatch":
        with pytest.raises(ValueError, match="strict"):
            TB.load_params_from_torch(model, {
                k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                strict=True)


@pytest.mark.parametrize("target,keys", [
    ("a.b", ["x.a.b", "a.b", "module.a.b"]),
    ("a.b", ["xa.b", "a.bc"]),
    ("bert.pooler.dense.weight", ["module.bert.pooler.dense.weight",
                                  "bert.pooler.dense.weight"]),
    ("w", ["w"]),
])
def test_suffix_match_matches_jax(target, keys):
    assert TB._suffix_match(target, keys) == JB._suffix_match(target, keys)


def test_convert_vit_cls_state_dict_matches_jax():
    rs = np.random.RandomState(0)
    sd = {k: rs.randn(2, 3).astype(np.float32) for k in (
        "module.blocks.0.attn.qkv.weight", "blocks.1.norm1.weight",
        "module.module.pos_embed", "cls_token", "patch_embed.proj.weight",
        "head.weight")}
    ref = JB.convert_vit_cls_state_dict_to_caption(sd)
    got = TB.convert_vit_cls_state_dict_to_caption(sd)
    assert list(got) == list(ref)
    assert all(got[k] is ref[k] for k in ref)


def test_load_torch_state_dict_matches_jax(tmp_path):
    """The {'model': ...} container is unwrapped and a bare state dict
    taken as it is, as the JAX bridge does."""
    rs = np.random.RandomState(1)
    sd = {"module.a.weight": torch.from_numpy(rs.randn(3, 2)
                                              .astype(np.float32)),
          "b.bias": torch.from_numpy(rs.randn(4).astype(np.float32))}
    for i, obj in enumerate(({"model": sd, "iteration": 3}, sd)):
        path = tmp_path / f"m{i}.pt"
        torch.save(obj, path)
        got, ref = TB.load_torch_state_dict(str(path)), \
            JB.load_torch_state_dict(str(path))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), ref[k])


def test_jax_snapshot_gives_the_jax_greedy_ids(tmp_path):
    """A JAX Checkpointer snapshot, read with the JAX load_state and
    carried across with load_jax_params, gives the port the JAX package's
    greedy ids."""
    jcfg, cfg = jax_tiny_config(), TC.tiny_config()
    params = _jax_params(3)
    rs = np.random.RandomState(4)
    params["cls"]["decoder"]["bias"] = (rs.randn(jcfg.vocab_size) * 2.0) \
        .astype(np.float32)
    path = JC.Checkpointer(str(tmp_path)).save(8, {"params": params})
    restored = JC.load_state(path)
    assert int(restored["iteration"]) == 8
    jparams = copy.deepcopy(restored["params"])
    model = TB.load_jax_params(TM.ViTCAP(cfg), jparams)
    imgs = rs.randint(0, 256, (B, cfg.img_size, cfg.img_size, 3)) \
        .astype(np.uint8)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    od = rs.randint(1, cfg.vocab_size, (B, od_len)).astype(np.int32)
    sl = np.array([cfg.max_seq_len, cfg.max_seq_a_len + 2], np.int32)
    kw = dict(max_length=cfg.max_gen_length,
              od_labels_start_posid=cfg.max_seq_a_len)
    ref = JD.generate_greedy(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(imgs),
        jnp.asarray(od), None, jnp.asarray(sl), jcfg,
        JD.DecodeOptions(**kw))["ids"]
    got = TD.generate_greedy(model, torch.from_numpy(imgs),
                             torch.from_numpy(od).long(), None,
                             torch.from_numpy(sl).long(), cfg,
                             TD.DecodeOptions(**kw))["ids"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
