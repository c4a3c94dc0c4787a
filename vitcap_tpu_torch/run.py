"""Experiment runner CLI of the port, the counterpart of the repository's
run.py with the same YAML surface:

    python -m vitcap_tpu_torch.run -c config.yaml [-p 'key: value'] \\
        [-bp <base64 yaml>]

The YAML selects a pipeline function via `type` and a pipeline class via
`param.pipeline_type: {from, import}`.  The reference's module paths
(src.pipelines.*) and the JAX package's (vitcap_tpu.pipelines.*) are
remapped onto vitcap_tpu_torch's, so one YAML drives either package.
Pipelines run on the card unless the YAML's param says `device: cpu`.

On N cards of a host, the same command under torch's launcher,

    python -m torch.distributed.run --nproc_per_node N \
        -m vitcap_tpu_torch.run -c config.yaml

runs one process a card: every rank runs the pipeline function, rank r on
cuda:r (LOCAL_RANK), in one NCCL process group made from the launcher's
MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK; training is data-parallel
over the global batch of effective_batch_size rows, predict shards are
merged by rank 0, and rank 0 evaluates (pipelines/uni_pipeline.py).
"""

from __future__ import annotations

import logging

from vitcap_tpu_torch.utils.common import (
    execute_func, init_logging, parse_general_args,
)

_CAPTION = "vitcap_tpu_torch.pipelines.caption_pipeline"
_UNI = "vitcap_tpu_torch.pipelines.uni_pipeline"

# reference and JAX-package pipeline modules -> the port's
_PIPELINE_REMAP = {
    "src.pipelines.tagger_caption_uni_pipeline_expanding_bertemb": _CAPTION,
    "src.pipelines.tagger_caption_uni_pipeline_expanding": _CAPTION,
    "src.pipelines.uni_pipeline": _UNI,
    "vitcap_tpu.pipelines.caption_pipeline": _CAPTION,
    "vitcap_tpu.pipelines.uni_pipeline": _UNI,
}


def create_pipeline(kwargs: dict):
    info = dict(kwargs.get("pipeline_type", {}))
    src = info.get("from", _CAPTION)
    info["from"] = _PIPELINE_REMAP.get(src, src)
    info.setdefault("import", "CaptionUniPipeline")
    param = {k: v for k, v in kwargs.items() if k != "pipeline_type"}
    return execute_func({"from": info["from"], "import": info["import"],
                         "param": param})


def load_pipeline(**kwargs):
    from vitcap_tpu_torch.utils.common import load_latest_parameters
    folder = kwargs.get("folder") or "output/" + kwargs["full_expid"]
    param = load_latest_parameters(folder)
    param.update(kwargs)
    param.pop("folder", None)
    return create_pipeline(param)


def pipeline_train_eval_multi(all_test_data, param, **kwargs):
    """Train once, then predict+evaluate every test split
    (reference run.py:47-75)."""
    init_logging()
    curr_param = dict(param)
    if all_test_data:
        curr_param.update(all_test_data[0])
    pip = create_pipeline(curr_param)
    pip.ensure_train()
    results = []
    for test_data in all_test_data:
        p = dict(param)
        p.update(test_data)
        pip = create_pipeline(p)
        pred = pip.ensure_predict()
        results.append(pip.ensure_evaluate(pred))
    if param.get("monitor_after"):
        pip.monitor_train()
    return results


def pipeline_eval_multi(all_test_data, param, **kwargs):
    """Evaluate an already-trained experiment (reference run.py:30-44)."""
    init_logging()
    results = []
    for test_data in all_test_data:
        p = dict(param)
        p.update(test_data)
        pip = create_pipeline(p)
        if not pip.is_train_finished():
            logging.info("training not finished; skip %s", test_data)
            continue
        pred = pip.ensure_predict()
        results.append(pip.ensure_evaluate(pred))
    return results


_TYPES = {
    "pipeline_train_eval_multi": pipeline_train_eval_multi,
    "pipeline_eval_multi": pipeline_eval_multi,
}


def main(argv=None):
    from vitcap_tpu_torch.parallel.distributed import shutdown
    kwargs = parse_general_args(argv)
    logging.info("param: %s", kwargs)
    fn = _TYPES[kwargs.pop("type")]
    try:
        return fn(**kwargs)
    finally:
        shutdown()


if __name__ == "__main__":
    main()
