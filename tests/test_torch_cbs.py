"""vitcap_tpu_torch's constrained beam search (models/cbs.py) against the
JAX package's, on the CPU, in one process (ConstraintFilter's dedup is
list(set(...)), whose order follows the process's string hash seed).

The model is tiny_config in f32 with the shipped vocab (30522 words) and an
LM-head bias drawn N(0, 3) from a numpy seed, which spreads the logits so
that no two candidates tie within float noise ([SEP]'s among the largest,
so beams finish); the JAX param tree is
loaded into the port through load_jax_params.  The JAX package's searches
run its eager ('heads') decode step; the port's run on both of its
engines (VITCAP_DECODE_FUSED=0, and =1, whose fused step the CPU runs as
its plain version).  Tolerances: FSMs, descriptors and token ids equal
(every FSM state and beam, dead beams' filler tokens included);
log-probabilities within 1e-5 (f32 sums in other orders); the pipeline's
predict rows equal, confs within rtol 1e-5.

Also decode_attention's beam groups: plan()'s choice from the shape, and
the plain version over an image's beams equal to the same beams as groups
that each repeat the image's context.
"""

import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitcap_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from vitcap_tpu.models import cbs as JC
from vitcap_tpu.models import decode as JD
from vitcap_tpu.models import vitcap as JM
from vitcap_tpu.models.config import tiny_config as jax_tiny_config
from vitcap_tpu.pipelines import caption_pipeline as JCP
from vitcap_tpu.solver import checkpoint_bridge as JB

from vitcap_tpu_torch.data.tokenization import DEFAULT_VOCAB, BertTokenizer
from vitcap_tpu_torch.models import cbs as TC
from vitcap_tpu_torch.models import config as TCF
from vitcap_tpu_torch.models import decode as TD
from vitcap_tpu_torch.models import vitcap as TM
from vitcap_tpu_torch.ops import decode_step as TDS
from vitcap_tpu_torch.pipelines import caption_pipeline as TCP
from vitcap_tpu_torch.solver import checkpoint_bridge as TB

from test_torch_pipeline import KEYS, make_dataset
from test_torch_pipeline import _param as pipeline_param

V = 30522
B = 2
C2T = {"dog": ["dog"], "fire": ["fire"], "hydrant": ["hydrant"],
       "cat": ["cat"], "teddy": ["teddy"], "bear": ["bear"]}
WF = {"dog": ["dog", "dogs"], "fire": ["fire"],
      "hydrant": ["hydrant", "hydrants"], "cat": ["cat", "cats"],
      "teddy": ["teddy"], "bear": ["bear", "bears"]}
CONSTRAINT_SETS = [[], ["dog"], ["dog", "cat"], ["fire hydrant"],
                   ["fire hydrant", "dog"], ["fire hydrant", "dog", "cat"],
                   ["dog", "dog"], ["teddy bear", "cat"]]
ENGINES = {"heads": "0", "flat": "1"}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tokenizers():
    return JaxTokenizer(str(DEFAULT_VOCAB)), BertTokenizer(str(DEFAULT_VOCAB))


def _builders(tokenizers, m=3):
    jt, tt = tokenizers
    return (JC.FiniteStateMachineBuilder(jt, C2T, WF, max_given_constraints=m),
            TC.FiniteStateMachineBuilder(tt, C2T, WF, max_given_constraints=m))


# ---------------------------------------------------------------------------
# host: filter, FSMs, descriptors, selection
# ---------------------------------------------------------------------------

def test_constraint_filter_matches_jax(tmp_path):
    hierarchy = {"LabelName": "Entity", "Subcategory": [
        {"LabelName": "Animal",
         "Subcategory": [{"LabelName": "Dog"}, {"LabelName": "Cat"}]},
        {"LabelName": "Vehicle", "Subcategory": [{"LabelName": "Car"}]},
        {"LabelName": "Kitchen & dining room table"}]}
    p = tmp_path / "h.json"
    p.write_text(json.dumps(hierarchy))
    rs = np.random.RandomState(5)
    names = ["dog", "animal", "car", "person", "cat", "vehicle",
             "kitchen & dining room table", "tree", "band-aid"]
    for thr, m in ((0.85, 3), (0.3, 2), (0.95, 5)):
        jf = JC.ConstraintFilter(str(p), thr, m)
        tf = TC.ConstraintFilter(str(p), thr, m)
        for _ in range(20):
            n = rs.randint(0, len(names) + 1)
            pick = list(rs.choice(names, n, replace=True))
            xy = rs.randint(0, 40, (n, 2)).astype(np.float64)
            boxes = np.concatenate([xy, xy + rs.randint(1, 30, (n, 2))], 1) \
                if n else np.zeros((0, 4))
            scores = rs.rand(n) - 0.1
            assert tf(boxes, pick, scores) == jf(boxes, pick, scores)


def test_load_wordforms_matches_jax(tmp_path):
    p = tmp_path / "wf.tsv"
    p.write_text("".join(f"{k}\t{','.join(v)}\n" for k, v in WF.items())
                 + "lonely\n")
    assert TC.load_wordforms(str(p)) == JC.load_wordforms(str(p)) == WF


def test_fsm_builders_match_jax(tokenizers):
    """Dense adjacency bit-equal to JAX's (and its sub-state count); the
    sparse builder's default/removed/edges equal to JAX's and densifying to
    the dense one; dense_to_sparse equal to JAX's."""
    jb, tb = _builders(tokenizers)
    for cons in CONSTRAINT_SETS:
        jd, jsub = jb.build(cons)
        td, tsub = tb.build(cons)
        assert tsub == jsub and td.dtype == np.uint8
        np.testing.assert_array_equal(td, jd, err_msg=str(cons))
        js, ts = JC.build_sparse_fsm(jb, cons), TC.build_sparse_fsm(tb, cons)
        np.testing.assert_array_equal(ts.default_to, js.default_to)
        assert ts.removed == js.removed and ts.edges == js.edges
        np.testing.assert_array_equal(ts.densify(), td, err_msg=str(cons))
    jd = jb.build(["fire hydrant", "dog"])[0]
    jr, tr = JC.dense_to_sparse(jd), TC.dense_to_sparse(jd)
    np.testing.assert_array_equal(tr.default_to, jr.default_to)
    assert tr.removed == jr.removed and tr.edges == jr.edges
    np.testing.assert_array_equal(tr.densify(), jd)


def test_sparse_batch_matches_jax(tokenizers):
    jb, tb = _builders(tokenizers)
    for pad in (16, 4):
        sets = CONSTRAINT_SETS[:5]
        want = JC.sparse_batch([JC.build_sparse_fsm(jb, c) for c in sets],
                               pad)
        got = TC.sparse_batch([TC.build_sparse_fsm(tb, c) for c in sets],
                              pad)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_select_best_beam_matches_jax():
    rs = np.random.RandomState(3)
    S, nb, A = 16, 3, 7
    beams = rs.randint(0, 200, (5, S, nb, A))
    beams[rs.rand(*beams.shape) < 0.2] = 102           # [SEP]s
    lps = rs.randn(5, S, nb) * 4
    n_cons = np.array([0, 1, 2, 3, 2])
    for min_sat in (1, 2, 3):
        want = JC.select_best_beam_with_constraints(beams, lps, n_cons,
                                                    min_sat, [102])
        got = TC.select_best_beam_with_constraints(beams, lps, n_cons,
                                                   min_sat, [102])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_top_k_matches_lax_and_exact_top_k():
    """top_k is lax.top_k's order (ties to the lower index, -0.0 == 0.0,
    -inf last); exact_top_k_jax is the JAX package's exact_top_k, index 0
    past a row's finite values included."""
    rs = np.random.RandomState(0)
    x = rs.randint(-3, 3, (6, 700)).astype(np.float32) * 1e20
    x[0, :] = -np.inf
    x[0, [5, 650]] = 0.0
    x[1, ::2] = -0.0
    x[2, :] = rs.randn(700)
    x[3, 100:] = -np.inf
    x[4, 3] = np.inf
    for k in (1, 5, 21):
        vals, idx = TC.top_k(torch.from_numpy(x), k)
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))
        vals, idx = TC.exact_top_k_jax(torch.from_numpy(x), k)
        wv, wi = JD.exact_top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))


# ---------------------------------------------------------------------------
# the searches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jax_tiny_config(vocab_size=V)
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    bias = np.random.RandomState(4).randn(V) * 3.0
    bias[jcfg.sep_token_id] = 12.3      # among the top words: beams finish
    params["cls"]["decoder"]["bias"] = bias.astype(np.float32)
    model = TB.load_jax_params(TM.ViTCAP(TCF.tiny_config(vocab_size=V)),
                               params)
    cfg = TCF.tiny_config(vocab_size=V)
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (B, cfg.img_size, cfg.img_size, 3)) \
        .astype(np.uint8)
    od_len = cfg.max_seq_len - cfg.max_seq_a_len
    od = rs.randint(1, V, (B, od_len)).astype(np.int32)
    sl = np.array([cfg.max_seq_a_len + 3, cfg.max_seq_len], np.int32)
    return dict(jcfg=jcfg, cfg=cfg, model=model, imgs=imgs, od=od, sl=sl,
                params=jax.tree_util.tree_map(jnp.asarray, params))


def _opts(cfg):
    kw = dict(max_length=cfg.max_gen_length,
              od_labels_start_posid=cfg.max_seq_a_len)
    return JD.DecodeOptions(**kw), TD.DecodeOptions(**kw)


def _inputs(m):
    j = (jnp.asarray(m["imgs"]), jnp.asarray(m["od"]), None,
         jnp.asarray(m["sl"]))
    t = (torch.from_numpy(m["imgs"]), torch.from_numpy(m["od"]).long(), None,
         torch.from_numpy(m["sl"]).long())
    return j, t


def _assert_search_equal(got, want):
    ids, lp = got["ids"].numpy(), got["logprobs"].numpy()
    assert ids.shape == np.asarray(want["ids"]).shape
    np.testing.assert_array_equal(ids, np.asarray(want["ids"]))
    np.testing.assert_allclose(lp, np.asarray(want["logprobs"]), rtol=0,
                               atol=1e-5)


# the dense search's (B, S, S, nb, V) masked block: 2 constraints (S = 16),
# 3 beams; the sparse search at the production sizes, 3 constraints (S =
# 32) and 5 beams
DENSE_CONS = [["fire hydrant", "dog"], ["cat", "dog"]]
SPARSE_CONS = [["fire hydrant", "dog", "cat"], ["teddy bear"]]


@pytest.fixture(scope="module")
def jax_searches(models, tokenizers):
    """The JAX package's dense and sparse searches (its eager step)."""
    os.environ.pop("VITCAP_DECODE_FUSED", None)
    jo, _ = _opts(models["cfg"])
    ji, _ = _inputs(models)
    jb2, _ = _builders(tokenizers, m=2)
    jb3, _ = _builders(tokenizers, m=3)
    fsm = np.stack([jb2.build(c)[0] for c in DENSE_CONS])
    dense = JC.constrained_beam_search(models["params"], *ji,
                                       jnp.asarray(fsm), models["jcfg"], jo,
                                       beam_size=3)
    sfsm = JC.sparse_batch([JC.build_sparse_fsm(jb2, c) for c in DENSE_CONS])
    sparse3 = JC.constrained_beam_search_sparse(
        models["params"], *ji, {k: jnp.asarray(v) for k, v in sfsm.items()},
        models["jcfg"], jo, beam_size=3)
    sfsm = JC.sparse_batch([JC.build_sparse_fsm(jb3, c)
                            for c in SPARSE_CONS])
    sparse = JC.constrained_beam_search_sparse(
        models["params"], *ji, {k: jnp.asarray(v) for k, v in sfsm.items()},
        models["jcfg"], jo, beam_size=5)
    return {"fsm": fsm, "dense": dense, "sparse3": sparse3, "sparse": sparse}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_dense_search_matches_jax(models, tokenizers, jax_searches, engine,
                                  monkeypatch):
    monkeypatch.setenv("VITCAP_DECODE_FUSED", ENGINES[engine])
    _, to = _opts(models["cfg"])
    _, ti = _inputs(models)
    got = TC.constrained_beam_search(
        models["model"], *ti, torch.from_numpy(jax_searches["fsm"]),
        models["cfg"], to, beam_size=3)
    want = jax_searches["dense"]
    _assert_search_equal(got, want)
    # finished beams: their rows are -inf but [SEP], so their top-k past
    # [SEP] takes the JAX package's filler (index 0), compared above
    ids = got["ids"].numpy()
    assert (ids[..., 1:-1] == models["cfg"].sep_token_id).any()


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_sparse_search_matches_jax(models, tokenizers, jax_searches, engine,
                                   monkeypatch):
    monkeypatch.setenv("VITCAP_DECODE_FUSED", ENGINES[engine])
    _, to = _opts(models["cfg"])
    _, ti = _inputs(models)
    _, tb3 = _builders(tokenizers, m=3)
    sfsm = TC.sparse_batch([TC.build_sparse_fsm(tb3, c)
                            for c in SPARSE_CONS])
    got = TC.constrained_beam_search_sparse(
        models["model"], *ti, {k: TC.put(v, "cpu") for k, v in sfsm.items()},
        models["cfg"], to, beam_size=5)
    assert got["ids"].shape == (B, 32, 5, models["cfg"].max_gen_length)
    _assert_search_equal(got, jax_searches["sparse"])


def test_sparse_search_equals_dense(models, tokenizers, jax_searches,
                                    monkeypatch):
    """On the dense FSM's live beams (above the finite dead sentinel) the
    sparse search's beams and log-probabilities are the dense search's."""
    monkeypatch.setenv("VITCAP_DECODE_FUSED", "1")
    _, to = _opts(models["cfg"])
    _, ti = _inputs(models)
    _, tb2 = _builders(tokenizers, m=2)
    dense = TC.constrained_beam_search(
        models["model"], *ti, torch.from_numpy(jax_searches["fsm"]),
        models["cfg"], to, beam_size=3)
    sfsm = TC.sparse_batch([TC.build_sparse_fsm(tb2, c) for c in DENSE_CONS])
    sparse = TC.constrained_beam_search_sparse(
        models["model"], *ti, {k: TC.put(v, "cpu") for k, v in sfsm.items()},
        models["cfg"], to, beam_size=3)
    _assert_search_equal(sparse, jax_searches["sparse3"])
    d_ids, d_lp = dense["ids"].numpy(), dense["logprobs"].numpy()
    s_ids, s_lp = sparse["ids"].numpy(), sparse["logprobs"].numpy()
    live = d_lp > -1e10
    assert live.sum() >= B * 3
    np.testing.assert_array_equal(s_ids[live], d_ids[live])
    np.testing.assert_allclose(s_lp[live], d_lp[live], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# CbsDecoder and the pipeline
# ---------------------------------------------------------------------------

def _cbs_files(root, keys):
    """Detections (dog, cat, a blacklisted person, a fire hydrant on the
    odd keys), the class hierarchy and the word files under root."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "boxes.tsv"), "w") as f:
        for i, k in enumerate(keys):
            dets = [{"class": "Dog", "conf": 0.9, "rect": [0, 0, 10, 10]},
                    {"class": "cat", "conf": 0.8, "rect": [20, 20, 30, 30]},
                    {"class": "person", "conf": 0.95, "rect": [0, 0, 9, 9]}]
            if i % 2:
                dets.append({"class": "fire hydrant", "conf": 0.7,
                             "rect": [40, 40, 50, 50]})
            f.write(f"{k}\t{json.dumps(dets)}\n")
    with open(os.path.join(root, "hierarchy.json"), "w") as f:
        json.dump({"LabelName": "Entity", "Subcategory": [
            {"LabelName": "Dog"}, {"LabelName": "Cat"},
            {"LabelName": "Fire hydrant"}]}, f)
    for name, d in (("c2t.tsv", C2T), ("wf.tsv", WF)):
        with open(os.path.join(root, name), "w") as f:
            f.writelines(f"{k}\t{','.join(v)}\n" for k, v in d.items())
    return {"cbs_boxes_tsv": os.path.join(root, "boxes.tsv"),
            "cbs_hierarchy_json": os.path.join(root, "hierarchy.json"),
            "cbs_constraint2tokens_tsv": os.path.join(root, "c2t.tsv"),
            "cbs_wordforms_tsv": os.path.join(root, "wf.tsv")}


def _decoder(pkg, tok, files, sparse, m):
    return pkg.CbsDecoder(
        tok, pkg.ConstraintFilter(files["cbs_hierarchy_json"], 0.85, m),
        pkg.FiniteStateMachineBuilder(
            tok, pkg.load_wordforms(files["cbs_constraint2tokens_tsv"]),
            pkg.load_wordforms(files["cbs_wordforms_tsv"]), m),
        pkg.ConstraintBoxesReader(files["cbs_boxes_tsv"]),
        min_constraints_to_satisfy=2, beam_size=3, sparse=sparse)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_cbs_decoder_matches_jax(models, tokenizers, tmp_path, engine,
                                 monkeypatch):
    """CbsDecoder.decode (constraints, FSMs, search, best beam) on both
    engines against the JAX package's, sparse (3 constraints) and dense
    (2); each best beam holds a constraint word."""
    keys = ["a", "b"]
    files = _cbs_files(str(tmp_path), keys)
    ji, ti = _inputs(models)
    # the od slots' token types, which the JAX package's dispatch needs
    ji = ji[:2] + (jnp.ones_like(ji[1]),) + ji[3:]
    ti = ti[:2] + (torch.ones_like(ti[1]),) + ti[3:]
    jo, to = _opts(models["cfg"])
    jt, tt = tokenizers
    words = set(tt.convert_tokens_to_ids(["dog", "dogs", "cat", "cats",
                                          "fire", "hydrant", "hydrants"]))
    for sparse, m in ((True, 3), (False, 2)):
        monkeypatch.delenv("VITCAP_DECODE_FUSED", raising=False)
        want = _decoder(JC, jt, files, sparse, m).decode(
            models["params"], *ji, keys, models["jcfg"], jo)
        monkeypatch.setenv("VITCAP_DECODE_FUSED", ENGINES[engine])
        got = _decoder(TC, tt, files, sparse, m).decode(
            models["model"], *ti, keys, models["cfg"], to)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
        for row in got[0]:
            assert words & set(row.tolist()), row


def _cbs_rows(cp_module, param, model_file):
    pip = cp_module.CaptionUniPipeline(**param)
    with open(pip.ensure_predict(model_file)) as f:
        return [(k, json.loads(v)) for k, v in
                (line.rstrip("\n").split("\t") for line in f)]


@pytest.fixture(scope="module")
def pipeline_root(tmp_path_factory):
    """The pipeline tests' synthetic TSV dataset (6 images, the shipped
    vocab), a basemodel `.pt` (the JAX package's init_params) copied once
    per package, the CBS files."""
    root = str(tmp_path_factory.mktemp("cbs_pipeline"))
    make_dataset(root)
    param = pipeline_param(root, "out")
    jcfg = JCP.CaptionUniPipeline(**param).model_cfg
    params = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(3), jcfg))
    params["cls"]["decoder"]["bias"] = (np.random.RandomState(6).randn(
        jcfg.vocab_size) * 3.0).astype(np.float32)
    for side in ("jax", "port"):
        os.makedirs(os.path.join(root, side))
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                    JB.params_to_torch_state_dict(params).items()},
                   os.path.join(root, side, "base.pt"))
    files = _cbs_files(os.path.join(root, "cbs"), KEYS)
    yield root, files
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_pipeline_cbs_predict_matches_jax(pipeline_root, sparse,
                                          monkeypatch):
    """use_cbs predict through both packages' CaptionUniPipeline on the
    same TSV and weights: equal rows, confs within rtol 1e-5, every caption
    holding a constraint word.  Sparse: 3 constraints, batches of 4 (the
    last of 2 padded with its last key); dense: 2 constraints, batches of
    2."""
    monkeypatch.delenv("VITCAP_DECODE_FUSED", raising=False)
    root, files = pipeline_root
    kw = dict(files, use_cbs=True, min_constraints_to_satisfy=1,
              cbs_sparse=int(sparse), force_predict=True)
    if not sparse:
        kw.update(cbs_max_constraints=2, test_batch_size=2)
    want = _cbs_rows(JCP, pipeline_param(root, "out_jax", **kw),
                     os.path.join(root, "jax", "base.pt"))
    got = _cbs_rows(TCP, pipeline_param(root, "out_port", device="cpu",
                                        **kw),
                    os.path.join(root, "port", "base.pt"))
    assert [k for k, _ in got] == [k for k, _ in want] == KEYS
    for (_, g), (_, w) in zip(got, want):
        assert [c["caption"] for c in g] == [c["caption"] for c in w]
        np.testing.assert_allclose([c["conf"] for c in g],
                                   [c["conf"] for c in w], rtol=1e-5)
        assert re.search(r"\b(dogs?|cats?|fire|hydrants?)\b",
                         g[0]["caption"]), g


def test_cli_predicts_and_evaluates_with_cbs(pipeline_root, tmp_path):
    """python -m vitcap_tpu_torch.run -c <yaml> with use_cbs: true: a
    released `.pt` in the experiment's snapshot folder is predicted with
    constrained beam search and evaluated (the `.report`'s metrics)."""
    import yaml
    from test_torch_pipeline import TEST
    from vitcap_tpu_torch import run as TR
    root, files = pipeline_root
    param = pipeline_param(root, str(tmp_path / "out"), device="cpu",
                           expid="cbs_cli", use_cbs=True,
                           min_constraints_to_satisfy=1, **files)
    snap = tmp_path / "out" / "tinycoco_tiny_cbs_cli" / "snapshot"
    snap.mkdir(parents=True)
    shutil.copy(os.path.join(root, "port", "base.pt"),
                snap / "model_iter_0000003.pt")
    (tmp_path / "cbs.yaml").write_text(yaml.safe_dump(
        {"type": "pipeline_eval_multi", "all_test_data": TEST,
         "param": param}))
    results = TR.main(["-c", str(tmp_path / "cbs.yaml")])
    assert len(results) == 1 and "CIDEr" in results[0]
    (pred,) = snap.glob("*.predict.tsv")
    with open(pred) as f:
        rows = [json.loads(line.rstrip("\n").split("\t")[1]) for line in f]
    assert len(rows) == len(KEYS)
    assert all(re.search(r"\b(dogs?|cats?|fire|hydrants?)\b",
                         r[0]["caption"]) for r in rows)


# ---------------------------------------------------------------------------
# decode_attention over beam groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,g", [(1, 1), (3, 3), (16, 16), (17, 1),
                                  (32, 16), (160, 16), (30, 15), (5, 5)])
def test_plan_groups(nb, g):
    """The beams of a launch row: the largest divisor of nb up to 16; the
    cluster plan is the plan of one group; greedy and beam-3 one group."""
    assert TDS.group_beams(nb) == g
    for dtype in (torch.bfloat16, torch.float32):
        p = TDS.plan(628, nb, 64, 20, dtype)
        assert p.groups == nb // g
        assert p[:4] == TDS.plan(628, g, 64, 20, dtype)[:4]
    assert TDS.plan(628, nb, 64, 20).ranks >= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_grouped_plain_equals_ungrouped(dtype):
    """decode_attention_plain over 2 images of 20 beams equals it over the
    same rows as 4 groups of 10 beams, each group with its image's context
    and bias repeated, as the kernels read them: bit-equal outputs and
    caption caches."""
    rs = np.random.RandomState(9)
    Bn, nb, g, nh, hd, S, A, t = 2, 20, 10, 2, 64, 90, 6, 4
    H = nh * hd

    def rnd(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
    qkv, ctx_k, ctx_v = rnd(Bn * nb, 2, 3 * H), rnd(Bn, S, H), rnd(Bn, S, H)
    cap_k, cap_v = rnd(Bn * nb, A, H), rnd(Bn * nb, A, H)
    bias = torch.where(torch.from_numpy(rs.rand(Bn, S) > 0.3), 0.0,
                       TDS.NEG_MASK_VALUE).float()
    caps = [cap_k.clone(), cap_v.clone()]
    whole = TDS.decode_attention_plain(qkv, *caps, ctx_k, ctx_v, bias, t, nh)
    rep = nb // g
    gcaps = [cap_k.clone(), cap_v.clone()]
    grouped = TDS.decode_attention_plain(
        qkv, *gcaps, ctx_k.repeat_interleave(rep, 0),
        ctx_v.repeat_interleave(rep, 0), bias.repeat_interleave(rep, 0), t,
        nh)
    assert torch.equal(whole, grouped)
    assert torch.equal(caps[0], gcaps[0]) and torch.equal(caps[1], gcaps[1])
