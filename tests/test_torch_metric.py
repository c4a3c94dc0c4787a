"""vitcap_tpu_torch.utils.metric (the tag meters and the train-time tag
probes) against vitcap_tpu.utils.metric on the same seeded inputs, within
1e-12; the port's meters also take torch tensors (float32, bfloat16,
bool) and give what the numpy arrays give.
"""

import numpy as np
import pytest
import torch

from vitcap_tpu.utils import metric as JM

from vitcap_tpu_torch.utils import metric as TM


def _tags(seed, n=24, k=13, density=0.2):
    rs = np.random.RandomState(seed)
    scores = rs.randn(n, k)
    target = (rs.rand(n, k) < density).astype(np.float32)
    target[0] = 0                              # a sample with no label
    target[:, 0] = 0                           # a class with no positive
    scores[3, :4] = scores[3, 4]               # ties
    return scores, target


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(want, float), rtol=0, atol=1e-12)


def test_average_meter_matches_jax():
    a, b = TM.AverageMeter(), JM.AverageMeter()
    for v, n in ((1.5, 1), (2.25, 3), (-0.5, 2)):
        a.update(v, n)
        b.update(v, n)
        assert (a.val, a.sum, a.count) == (b.val, b.sum, b.count)
        _close(a.avg, b.avg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multilabel_accuracy_matches_jax(seed):
    a, b = TM.MultiLabelAccuracy(), JM.MultiLabelAccuracy()
    for s in range(3):
        out, tgt = _tags(10 * seed + s)
        a.calc(out, tgt)
        b.calc(out, tgt)
    _close(a.prec(), b.prec())
    assert a.accuracy.count == b.accuracy.count
    empty = TM.MultiLabelAccuracy()
    empty.calc(np.zeros((2, 3)), np.zeros((2, 3)))
    assert empty.prec() == 0.0 and empty.accuracy.count == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap_and_map_meters_match_jax(seed):
    ap, jap = TM.APMeter(), JM.APMeter()
    mp, jmp = TM.mAPMeter(), JM.mAPMeter()
    for s in range(3):
        out, tgt = _tags(10 * seed + s)
        for m in (ap, jap, mp, jmp):
            m.add(out, tgt)
    _close(ap.value(), jap.value())
    _close(mp.value(), jmp.value())
    ap.add(out[0], tgt[0])                     # one row (1-D) at a time
    jap.add(out[0], tgt[0])
    _close(ap.value(), jap.value())
    ap.reset()
    mp.reset()
    assert ap.value().size == 0 and mp.value() == 0.0
    with pytest.raises(ValueError, match="differ in shape"):
        ap.add(out, tgt[:, :3])


def test_probes_match_jax():
    rs = np.random.RandomState(5)
    vocab = {i: f"tag{i}" for i in range(40)}
    logits = rs.randn(4, 40) * 3
    for kw in ({}, {"topk": 5}, {"topk": 10, "threshold": 0.6}):
        assert TM.logit_to_label(logits, vocab, **kw) == \
            JM.logit_to_label(logits, vocab, **kw)
    labels = (rs.rand(4, 40) < 0.1).astype(np.int64)
    assert TM.label_to_label(labels, vocab) == \
        JM.label_to_label(labels, vocab)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meters_take_torch_tensors(dtype):
    out, tgt = _tags(7)
    t_out = torch.from_numpy(out).to(dtype)
    t_tgt = torch.from_numpy(tgt).bool()
    ref = t_out.float().numpy()          # what the meters see
    tgt = t_tgt.numpy()
    a, b = TM.MultiLabelAccuracy(), JM.MultiLabelAccuracy()
    a.calc(t_out, t_tgt)
    b.calc(ref, tgt)
    _close(a.prec(), b.prec())
    ap, jap = TM.APMeter(), JM.APMeter()
    ap.add(t_out, t_tgt)
    jap.add(ref, tgt)
    _close(ap.value(), jap.value())
    vocab = {i: f"t{i}" for i in range(out.shape[1])}
    assert TM.logit_to_label(t_out, vocab, topk=4) == \
        JM.logit_to_label(ref, vocab, topk=4)
    assert TM.label_to_label(t_tgt, vocab) == JM.label_to_label(tgt, vocab)
