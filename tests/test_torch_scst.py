"""vitcap_tpu_torch SCST (solver/scst.py) and its CIDEr-D copy
(evals/metrics.py) vs the JAX package, on the CPU.

The same weights (the JAX param tree through load_jax_params) and numpy
inputs go through both packages at tiny_config(img_size=128): 65 visual
tokens, a 76-token context and 6 caption slots, so the probe layout's
2A + S = 88 tokens pad to 96 and the decoder's split train blocks engage;
the JAX side runs its train kernels with VITCAP_TRAIN_PALLAS=interpret.
Sampling draws from different generators in the two packages (F3), so the
gradient step is compared given the same sampled ids, raw tokens,
advantages and TokenSample indices.
"""

import pickle
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.evals import metrics as JMet
from vitcap_tpu.models import decode as JD
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.solver import scst as JS
from vitcap_tpu.solver import train_step as JT

from vitcap_tpu_torch.data.tokenization import CaptionDecoder
from vitcap_tpu_torch.evals import metrics as TMet
from vitcap_tpu_torch.models import config as TC
from vitcap_tpu_torch.models import decode as TD
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.solver import checkpoint_bridge as TB
from vitcap_tpu_torch.solver import scst as TS
from vitcap_tpu_torch.solver import train_step as TT

B, K = 2, 2
KW = dict(img_size=128)
WORDS = ("a man dog cat on the red blue riding sitting table grass with "
         "two of in street").split()


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("VITCAP_TRAIN_PALLAS", "interpret")


def _setup():
    jcfg, cfg = jax_tiny_config(**KW), TC.tiny_config(**KW)
    params = jax.tree_util.tree_map(
        np.array, JM.init_params(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(31)
    for path, a in TB.flatten_params(params).items():
        if path.endswith("bias"):          # non-zero, so they are tested
            a[...] = rs.randn(*a.shape).astype(np.float32) * 0.02
    # spread the caption logits (the random init leaves them nearly flat)
    params["cls"]["decoder"]["bias"] = (
        rs.randn(jcfg.vocab_size) * 2.0).astype(np.float32)
    model = TB.load_jax_params(TM.ViTCAP(cfg), params)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    batch = {
        "image": rs.randint(0, 256, (B, cfg.img_size, cfg.img_size, 3))
                 .astype(np.uint8),
        "od_ids": rs.randint(1, cfg.vocab_size, (B, od_len)).astype(np.int32),
        "seq_len": np.array([cfg.max_seq_len, cfg.max_seq_len - 3],
                            np.int32),
    }
    A = cfg.max_gen_length
    ids = rs.randint(1, cfg.vocab_size, (B * K, A)).astype(np.int32)
    ids[:, 0] = cfg.cls_token_id
    ids[ids == cfg.sep_token_id] = 7
    ids[0, 3], ids[0, 4:] = cfg.sep_token_id, cfg.pad_token_id  # ends early
    ids[2, 1], ids[2, 2:] = cfg.sep_token_id, cfg.pad_token_id  # at once
    ids[3, A - 1] = cfg.sep_token_id                # forced at max length
    raw = ids[:, 1:].copy()
    raw[0, 3:] = rs.randint(1, cfg.vocab_size, A - 4)  # drawn after EOS
    raw[3, -1] = 9                                  # the sampled token
    opts = dict(max_length=A, od_labels_start_posid=cfg.max_seq_a_len)
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=model, batch=batch,
                ids=ids, raw=raw, jopts=JD.DecodeOptions(**opts),
                topts=TD.DecodeOptions(**opts), rs=rs)


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _tb(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _captions(rs, n, lo=3, hi=9):
    return [" ".join(rs.choice(WORDS, rs.randint(lo, hi))) + "."
            for _ in range(n)]


# ---------------------------------------------------------------------------
# reward
# ---------------------------------------------------------------------------

def test_wrap_sentence():
    for s in ("a dog.", " a dog . ", "a dog", "", "a dog.."):
        assert TS.wrap_sentence(s) == JS.wrap_sentence(s)
    assert TS.wrap_sentence(" two cats. ") == "two cats <eos>"


def _cider_inputs(seed=0, n=6, refs=5):
    rs = np.random.RandomState(seed)
    gts = {i: _captions(rs, refs) for i in range(n)}
    res = {i: _captions(rs, 1) for i in range(n)}
    res[0] = [gts[0][1]]                      # one exact match
    return gts, res


@pytest.mark.parametrize("native", ["0", "1"])
@pytest.mark.parametrize("df", ["corpus", "pickle"])
def test_cider_d_matches_jax(monkeypatch, tmp_path, native, df):
    """The port's CiderD against the JAX package's, each on its Python
    path (VITCAP_NATIVE_CIDER=0) and its native path (the C++ scorer,
    used in corpus mode), within 1e-9: in corpus mode, and with a
    document frequency pickle in the cider repo's format (Python on both
    sides whatever the variable says)."""
    monkeypatch.setenv("VITCAP_NATIVE_CIDER", native)
    gts, res = _cider_inputs()
    if df == "pickle":
        freq = defaultdict(float)
        for refs in _cider_inputs(seed=1, n=20)[0].values():
            for g in set(g for r in refs for g in TMet._ngram_counter(r)):
                freq[g] += 1
        for refs in gts.values():           # every n-gram seen at least once
            for g in set(g for r in refs + res[0]
                         for g in TMet._ngram_counter(r)):
                freq[g] += 0.5
        for hyp in res.values():
            for g in TMet._ngram_counter(hyp[0]):
                freq.setdefault(g, 0.0)
        path = tmp_path / "df.p"
        with open(path, "wb") as f:
            pickle.dump({"ref_len": 20.0, "document_frequency": freq}, f)
        mode = str(path)
    else:
        mode = "corpus"
    ref_mean, ref = JMet.CiderD(df=mode).compute_score(gts, res)
    mean, got = TMet.CiderD(df=mode).compute_score(gts, res)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    assert abs(mean - ref_mean) <= 1e-9
    assert got[0] > got[1:].max()             # the exact match wins


def test_ngram_counter_matches_jax():
    for s in ("a b a b a", "", "one", "a man on a red table"):
        assert TMet._ngram_counter(s) == JMet._ngram_counter(s)
        assert TMet._ngram_counter(s, 2) == JMet._ngram_counter(s, 2)


@pytest.mark.parametrize("baseline", ["greedy", "sample"])
def test_scst_reward_matches_jax(baseline):
    """Advantages (B * K,) for both baselines, against the JAX package's
    ScstReward on the same captions (corpus df: both packages' native
    C++ scorers, the same arithmetic); and by hand: the greedy baseline is
    each image's greedy score, the sample baseline the mean of the
    image's other samples."""
    rs = np.random.RandomState(5)
    gt = [_captions(rs, 5) for _ in range(3)]
    greedy = _captions(rs, 3)
    samples = _captions(rs, 3 * K)
    samples[0] = gt[0][0]
    ref = JS.ScstReward("corpus", baseline)(gt, greedy, samples)
    reward = TS.ScstReward("corpus", baseline)
    got = reward(gt, greedy, samples)
    assert got.dtype == np.float32 and got.shape == (3 * K,)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    gen = samples + (greedy if baseline == "greedy" else [])
    idx = [i // K for i in range(3 * K)] + list(range(3))
    _, sc = TMet.CiderD().compute_score(
        {i: [TS.wrap_sentence(c) for c in gt[idx[i]]]
         for i in range(len(gen))},
        {i: [TS.wrap_sentence(g)] for i, g in enumerate(gen)})
    s = sc[:3 * K].reshape(3, K)
    base = (sc[3 * K:][:, None] if baseline == "greedy"
            else (s.sum(1, keepdims=True) - s) / (K - 1))
    np.testing.assert_allclose(got, (s - base).reshape(-1), rtol=1e-6)
    assert reward.get_score() == pytest.approx(float(s.mean()))
    with pytest.raises(ValueError):
        TS.ScstReward("corpus", "beam")


# ---------------------------------------------------------------------------
# probe-layout scoring
# ---------------------------------------------------------------------------

def test_probe_allow_mask_matches_jax_layout():
    """The allow-mask rows of the probe layout: real t sees real <= t,
    probe t sees real < t and itself, both see the valid context; od rows
    the valid context; tagCLS/visual rows tagCLS/visual."""
    A, od_len, S = 3, 2, 5
    valid = torch.tensor([[True, False, True, True, True]])
    m = TS.probe_allow_mask(valid, od_len, A)[0]
    assert m.shape == (2 * A + S, 2 * A + S)
    assert m[1, :A].tolist() == [True, True, False]
    assert m[A + 1, :2 * A].tolist() == [True, False, False,
                                         False, True, False]
    assert m[A, :2 * A].tolist() == [False] * 3 + [True, False, False]
    assert m[0, 2 * A:].tolist() == valid[0].tolist()
    assert m[2 * A, 2 * A:].tolist() == valid[0].tolist()
    assert m[2 * A + 3, 2 * A:].tolist() == [False, False, True, True, True]
    assert not m[2 * A:, :2 * A].any()


@pytest.mark.parametrize("ratio", [1.0, 0.7])
def test_score_caption_logprobs_matches_jax(interpret, setup, ratio):
    """f32, within 1e-4: the probe layout over K = 2 captions an image,
    the raw tokens as targets (a forced EOS, tokens after an EOS), on all
    visual tokens and on a TokenSample subset; the port's scoring runs
    with gradients, its train blocks engaged."""
    s = setup
    cfg = s["cfg"]
    vidx = None
    if ratio < 1.0:
        keep = int(round(ratio * cfg.num_visual_tokens))
        vidx = np.stack([np.concatenate(
            [[0], s["rs"].permutation(cfg.num_visual_tokens - 1)[:keep - 1]
             + 1]) for _ in range(B)]).astype(np.int32)
    jb = _jb(s["batch"])
    ref = JS.score_caption_logprobs(
        jax.tree_util.tree_map(jnp.asarray, s["params"]), jb["image"],
        jb["od_ids"], None, jb["seq_len"], jnp.asarray(s["ids"]), s["jcfg"],
        s["jopts"], target_ids=jnp.asarray(s["raw"]),
        visual_token_idx=None if vidx is None else jnp.asarray(vidx))
    tb = _tb(s["batch"])
    model = s["model"].requires_grad_(True)
    try:
        got = TS.score_caption_logprobs(
            model, tb["image"], tb["od_ids"], None, tb["seq_len"],
            torch.from_numpy(s["ids"]).long(), cfg, s["topts"],
            target_ids=torch.from_numpy(s["raw"]).long(),
            visual_token_idx=None if vidx is None
            else torch.from_numpy(vidx).long())
        assert got.requires_grad
    finally:
        model.requires_grad_(False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-4)


def test_score_matches_the_decode_loops_sampled_logprobs(setup):
    """Re-scoring the port's own sampled captions (K = 2 per image) gives
    the decode loop's normalised logprobs, within 1e-4 (f32): the probe
    layout reproduces each step's MASK-peek distribution."""
    s = setup
    cfg, model = s["cfg"], s["model"]
    tb = _tb(s["batch"])
    opts = TD.DecodeOptions(max_length=cfg.max_gen_length, do_sample=True,
                            num_return_sequences=K,
                            od_labels_start_posid=cfg.max_seq_a_len)
    out = TD.generate_greedy(model, tb["image"], tb["od_ids"], None,
                             tb["seq_len"], cfg, opts,
                             rng=torch.Generator().manual_seed(3))
    ids = out["ids"].reshape(B * K, -1)
    with torch.no_grad():
        got = TS.score_caption_logprobs(
            model, tb["image"], tb["od_ids"], None, tb["seq_len"], ids, cfg,
            opts, target_ids=out["raw_tokens"])
    np.testing.assert_allclose(got.numpy(), out["logprobs"].reshape(-1)
                               .numpy(), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the SCST step
# ---------------------------------------------------------------------------

HYPER = dict(base_lr=1e-3, max_iter=20, warmup_steps=1)


@pytest.mark.parametrize("ratio", [1.0, 0.7])
def test_grad_step_matches_jax(interpret, ratio):
    """One grad_step against the JAX package's, given the same sampled
    ids, raw tokens, advantages and TokenSample indices (F3: the sampling
    streams differ).  f32 tolerances: loss, grad norm and mean logprob
    1e-4 relative (sums over the encoder and 2 decoder layers' backwards
    in another order); the new parameters 2e-3 of lr around their values
    and the moments 1e-4 / 3e-4 of their leaf's scale, the rules of
    test_torch_train_step.py's two-step test."""
    s = _setup()
    cfg, jcfg = s["cfg"], s["jcfg"]
    scst = dict(num_return=K, visual_token_ratio=ratio)
    adv = s["rs"].randn(B * K).astype(np.float32)
    keep = (int(round(ratio * cfg.num_visual_tokens)) if ratio < 1.0
            else 0)
    vidx = np.stack([np.concatenate(
        [[0], s["rs"].permutation(cfg.num_visual_tokens - 1)[:keep - 1]
         + 1]) for _ in range(B)]).astype(np.int32) if keep \
        else np.zeros((B, 0), np.int32)
    _, jgrad = JS.make_scst_fns(jcfg, s["jopts"], JS.ScstConfig(**scst),
                                JT.TrainHyper(**HYPER))
    jstate = JT.init_train_state(
        jax.tree_util.tree_map(jnp.asarray, s["params"]),
        jax.random.PRNGKey(1))
    jstate, jm = jgrad(jstate, _jb(s["batch"]), jnp.asarray(s["ids"]),
                       jnp.asarray(s["raw"]), jnp.asarray(adv),
                       jnp.asarray(vidx))
    _, grad = TS.make_scst_fns(cfg, s["topts"], TS.ScstConfig(**scst),
                               TT.TrainHyper(**HYPER))
    state = TT.init_train_state(s["model"], None)
    state, m = grad(state, _tb(s["batch"]),
                    torch.from_numpy(s["ids"]).long(),
                    torch.from_numpy(s["raw"]).long(),
                    torch.from_numpy(adv), torch.from_numpy(vidx).long())
    for key in ("scst_loss", "grad_norm", "mean_logprob"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-4,
                                   err_msg=key)
    assert state.opt.step == int(jstate.opt.step) == 1
    lr = HYPER["base_lr"]
    got = TB.state_to_jax_flat(dict(state.model.named_parameters()))
    ref = TB.flatten_params(jax.tree_util.tree_map(np.asarray,
                                                   jstate.params))
    assert got.keys() == ref.keys()
    for path, want in ref.items():
        np.testing.assert_allclose(got[path], want, rtol=0, atol=2e-3 * lr,
                                   err_msg=path)
    for what, tree, jtree, tol, floor in (
            ("mu", state.opt.mu, jstate.opt.mu, 1e-4, 1e-8),
            ("nu", state.opt.nu, jstate.opt.nu, 3e-4, 1e-16)):
        got = TB.state_to_jax_flat(tree)
        ref = TB.flatten_params(jax.tree_util.tree_map(np.asarray, jtree))
        for path, want in ref.items():
            scale = max(float(np.abs(want).max()), floor)
            np.testing.assert_allclose(got[path], want, rtol=0,
                                       atol=tol * scale,
                                       err_msg=f"{what} {path}")


def test_decode_fn_greedy_ids_match_jax(setup):
    """decode_fn's greedy baseline is deterministic: the JAX package's ids.
    The samples: K per image, raw tokens that agree with the ids wherever
    the sentence was unfinished; no TokenSample at ratio 1 (a (B, 0)
    index), keep indices, CLS first, at ratio 0.7."""
    s = setup
    cfg = s["cfg"]
    jdec, _ = JS.make_scst_fns(s["jcfg"], s["jopts"],
                               JS.ScstConfig(num_return=K),
                               JT.TrainHyper(**HYPER))
    jb = _jb(s["batch"])
    jg = jdec(jax.tree_util.tree_map(jnp.asarray, s["params"]), jb["image"],
              jb["od_ids"], None, jb["seq_len"], jax.random.PRNGKey(0))[0]
    tb = _tb(s["batch"])
    dec, _ = TS.make_scst_fns(cfg, s["topts"], TS.ScstConfig(num_return=K),
                              TT.TrainHyper(**HYPER))
    g, smp, raw, vidx = dec(s["model"], tb["image"], tb["od_ids"], None,
                            tb["seq_len"], torch.Generator().manual_seed(0))
    assert torch.equal(g, torch.from_numpy(np.array(jg)).long())
    A = cfg.max_gen_length
    assert smp.shape == (B * K, A) and raw.shape == (B * K, A - 1)
    assert vidx.shape == (B, 0)
    unfin = torch.cumsum(smp[:, 1:] == cfg.sep_token_id, 1) == 0
    both = torch.cat([torch.ones(B * K, 1, dtype=torch.bool),
                      unfin[:, :-1]], 1)[:, :-1]
    assert torch.equal(smp[:, 1:-1][both], raw[:, :-1][both])
    dec7, _ = TS.make_scst_fns(cfg, s["topts"],
                               TS.ScstConfig(num_return=K,
                                             visual_token_ratio=0.7),
                               TT.TrainHyper(**HYPER))
    *_, vidx = dec7(s["model"], tb["image"], tb["od_ids"], None,
                    tb["seq_len"], torch.Generator().manual_seed(0))
    assert vidx.shape == (B, 46) and (vidx[:, 0] == 0).all()
    assert all(len(set(r)) == 46 for r in vidx.tolist())


def test_scst_train_step_runs_and_refuses_a_mesh():
    """The whole step on the CPU with the port's CaptionDecoder: finite
    loss and norm, a CIDEr-D score, the optimizer advanced; a mesh (the
    distributed port's) raises."""
    s = _setup()
    cfg = s["cfg"]
    dec, grad = TS.make_scst_fns(cfg, s["topts"], TS.ScstConfig(num_return=K),
                                 TT.TrainHyper(**HYPER))
    tok = CaptionDecoder()
    tb = _tb(s["batch"])
    # references that one of each image's samples repeats (the same
    # generator seed draws the same samples), so the advantages are not 0
    smp = dec(s["model"], tb["image"], tb["od_ids"], None, tb["seq_len"],
              torch.Generator().manual_seed(1))[1]
    gt = [[tok.decode(smp[i * K].tolist())] + _captions(s["rs"], 4)
          for i in range(B)]
    state = TT.init_train_state(s["model"], None)
    state, m = TS.scst_train_step(dec, grad, TS.ScstReward(),
                                  CaptionDecoder(), state, _tb(s["batch"]),
                                  gt, torch.Generator().manual_seed(1))
    assert state.opt.step == 1
    assert np.isfinite(m["scst_loss"].item())
    assert np.isfinite(m["grad_norm"].item()) and m["grad_norm"].item() > 0
    assert m["cider_score"] > 0
    with pytest.raises(ValueError, match="mesh"):
        TS.make_scst_fns(cfg, s["topts"], TS.ScstConfig(),
                         TT.TrainHyper(), mesh=object())
    with pytest.raises(ValueError, match="mesh"):
        TS.scst_train_step(dec, grad, TS.ScstReward(), CaptionDecoder(),
                           state, _tb(s["batch"]), gt, None, mesh=object())
