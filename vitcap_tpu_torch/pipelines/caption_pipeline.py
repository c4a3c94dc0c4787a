"""ViTCAP captioning pipeline: datasets, model assembly, train loop, decode
prediction, caption evaluation; the port of
vitcap_tpu/pipelines/caption_pipeline.py (reference ViTCAP
src/pipelines/tagger_caption_uni_pipeline_expanding_bertemb.py:192-778).

The same YAML keys drive it.  Training runs the port's make_train_step
(the split train blocks and their kernels) and snapshots through the
port's Checkpointer; SCST runs solver.scst; prediction runs
models.decode.generate on the eager engine, or the fused one with
VITCAP_DECODE_FUSED=1, and with use_cbs models.cbs's constrained beam
search under detector-given concept words on either engine.

Under `python -m torch.distributed.run --nproc_per_node N` the training is
data-parallel (solver/train_step.py: each rank takes
effective_batch_size / N rows of each global batch, and the step is the
global batch's), only rank 0 snapshots, a SIGTERM stops every rank at
the same iteration, and each rank predicts its shard of the test set.
`mesh_data`, the JAX package's data-axis size, must be unset or N.  Keys
whose machinery is not ported raise, naming the ROADMAP.md item: loader:
grain, checkpoint_backend other than 'torch', async_checkpoint,
jax_profile_dir.
"""

from __future__ import annotations

import json
import logging
import os.path as op
import signal
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from .uni_pipeline import UniPipeline
from ..data.dataset import (
    CaptionIdxTSVDataset, Compose, IdentifyTextAB, ImageIdxTSVDataset,
    LoadCaption, LoadHW, LoadImage, LoadLabel, RemoveUselessKeys, RenameKey,
    TagTensorize, TransCaptionTensorizer,
)
from ..data.tensorizers import CaptionTaggerTensorizer, CaptionTensorizer
from ..data.tokenization import BertTokenizer
from ..data.transforms import TestImageTransform, TrainImageTransform
from ..models.config import ModelConfig, vit_trunk
from ..parallel.distributed import any_process
from ..parallel.mesh import check_mesh_data, rank_seed, replicate_params
from ..utils.common import Config, asset_path, resolve_asset
from ..utils.meters import MetricLogger


def _not_ported(key: str, what: str) -> NotImplementedError:
    return NotImplementedError(f"{key}: {what} is not ported to "
                               f"vitcap_tpu_torch yet (ROADMAP.md queue 1)")


class CaptionUniPipeline(UniPipeline):
    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        self._default.update({
            "mask_type": "seq2seq",
            "max_seq_a_length": 40,
            "max_seq_length": 70,
            "add_od_labels": True,
            "od_label_conf": 0.2,
            "drop_out": 0.1,
            "tie_weights": True,
            "label_smoothing": 0.1,
            "max_gen_length": 20,
            "max_masked_tokens": 3,
            "cider_cached_tokens": "data/coco_caption/gt/coco-train-words.p",
            "num_beams": 1,
            "mask_prob": 0.15,
            "replace_by_mask_prob": 0.8,
            "replace_by_rand_prob": 0.1,
            "temperature": 1.0,
            "top_k": 0,
            "top_p": 1.0,
            "do_sample": False,
            "repetition_penalty": 1.0,
            "length_penalty": 1.0,
            "gradient_clip": 1.0,
            "optimizer_type": "MAdamW",
            "bias_no_weight_decay": True,
            "ln_no_weight_decay": True,
            "unique_labels_on": False,
            "scheduler_type": "linear",
            "pad_to_max": True,
            "no_sort_by_conf": False,
            "real_text_a_in_test": False,
            "text_encoder_type": asset_path("VILT-L12-H784-uncased_16_384"),
            "image_encoder_type": "VitEmb_vit_base_patch16_384",
            "lr_multiplier": 0.1,
            "split_blocks": 4,
            "topk": 50,
            "loss": "focal",
            "category": "bert",
            "encode": "nltk",
            "tagemb": "cls",
            "weight_decay": 0.05,
            "train_transform": "vit",
            "input_small_scale": 0.08,
            "compute_dtype": "float32",
            "tag_loss_weight": 0.0,
            "mesh_data": None,
            "caption_version": None,
            # SCST (reference …expanding.py:404-478)
            "scst": False,
            "scst_num_return": 2,
            "sc_baseline_type": "greedy",
            # constrained beam search (reference use_cbs path)
            "use_cbs": False,
            "cbs_boxes_tsv": None,
            "cbs_hierarchy_json": None,
            "cbs_constraint2tokens_tsv": None,
            "cbs_wordforms_tsv": None,
            "cbs_nms_threshold": 0.85,
            "cbs_max_constraints": 3,
            "min_constraints_to_satisfy": 2,
        })
        # re-resolve config with the updated defaults
        self.cfg = Config(self._default, self.kwargs)
        self._check_ported()
        self._tokenizer: Optional[BertTokenizer] = None
        self._model_cfg: Optional[ModelConfig] = None
        self.train_meters: Optional[MetricLogger] = None

    def _check_ported(self) -> None:
        """Raise on the keys whose machinery the port does not have; none
        of them is ignored."""
        c = self.cfg
        if c.get("loader") == "grain":
            raise _not_ported("loader: grain", "the Grain loader (a "
                              "JAX-ecosystem loader; the port's loader is "
                              "the thread-pool DataLoader)")
        check_mesh_data(c.mesh_data, self.mpi_size)
        if c.get("checkpoint_backend") not in (None, "torch"):
            raise ValueError(
                f"checkpoint_backend={c.get('checkpoint_backend')!r}: the "
                f"port has one backend, 'torch' (msgpack and orbax are the "
                f"JAX package's formats)")
        if c.get("async_checkpoint"):
            raise ValueError("async_checkpoint is the JAX package's orbax "
                             "machinery; the port saves synchronously")
        if c.get("jax_profile_dir"):
            raise _not_ported("jax_profile_dir", "the profiler hooks (as "
                              "torch.profiler hooks)")

    # ------------------------------------------------------------------
    # pieces
    # ------------------------------------------------------------------

    @property
    def tokenizer(self) -> BertTokenizer:
        if self._tokenizer is None:
            self._tokenizer = BertTokenizer(op.join(
                resolve_asset(self.cfg.text_encoder_type), "vocab.txt"))
        return self._tokenizer

    @property
    def model_cfg(self) -> ModelConfig:
        """ModelConfig from the BertConfig json + pipeline knobs (reference
        get_fusion_config …bertemb.py:520-563)."""
        if self._model_cfg is not None:
            return self._model_cfg
        with open(op.join(resolve_asset(self.cfg.text_encoder_type),
                          "config.json")) as f:
            j = json.load(f)
        # 'VitEmb_<timm-name>' (reference get_image_encoder_model
        # …bertemb.py:750-778): the trunk's patch and depth from the model
        # zoo's spec
        patch, hidden, depth = vit_trunk(self.cfg.image_encoder_type)
        num_layers = j["num_hidden_layers"]
        # trunk and fusion share one width; when a down-scaled fusion
        # json is used (tiny test configs), the json's dims win
        if hidden == j["hidden_size"]:
            num_layers = depth
        # category 'vinvl': tag head over the detector label vocab
        # (reference modeling_bert.py:1327-1333, yaml/vinvl_label.json)
        tag_vocab_size = j["vocab_size"]
        if self.cfg.category == "vinvl":
            tag_vocab_size = len(self.vinvl_vocab["label_to_idx"])
        self._model_cfg = ModelConfig(
            hidden_size=j["hidden_size"],
            num_attention_heads=j["num_attention_heads"],
            intermediate_size=j["intermediate_size"],
            num_hidden_layers=num_layers,
            decoder_layers=int(self.cfg.get("decoder_layers", 4) or 4),
            split_blocks=int(self.cfg.split_blocks),
            vocab_size=j["vocab_size"],
            max_position_embeddings=j["max_position_embeddings"],
            type_vocab_size=j["type_vocab_size"],
            tag_vocab_size=tag_vocab_size,
            img_size=int(self.cfg.train_crop_size),
            patch_size=patch,
            bert_layer_norm_eps=j["layer_norm_eps"],
            hidden_dropout_prob=float(self.cfg.drop_out),
            attention_probs_dropout_prob=j["attention_probs_dropout_prob"],
            topk=int(self.cfg.topk),
            max_seq_len=int(self.cfg.max_seq_length),
            max_seq_a_len=int(self.cfg.max_seq_a_length),
            max_gen_length=int(self.cfg.max_gen_length),
            max_masked_tokens=int(self.cfg.max_masked_tokens),
            label_smoothing=float(self.cfg.label_smoothing),
            tag_loss=self.cfg.loss,
            tag_loss_weight=float(self.cfg.tag_loss_weight),
            tagemb=self.cfg.tagemb,
            tie_weights=bool(self.cfg.tie_weights),
            tie_tag_weights=bool(self.cfg.get("tie_tag_weights") or False),
            mask_type=self.cfg.mask_type,
            dtype=self.cfg.compute_dtype,
            token_filter_keep=float(self.cfg.get("token_filter_keep") or 0.0),
            token_filter_block=int(self.cfg.get("token_filter_block") or 2),
        )
        return self._model_cfg

    def train_caption_tensorizer(self) -> CaptionTensorizer:
        return CaptionTensorizer(
            self.tokenizer,
            max_seq_length=self.cfg.max_seq_length,
            max_seq_a_length=self.cfg.max_seq_a_length,
            mask_prob=self.cfg.mask_prob,
            max_masked_tokens=self.cfg.max_masked_tokens,
            mask_type=self.cfg.mask_type,
            is_train=True,
            replace_by_mask_prob=self.cfg.replace_by_mask_prob,
            replace_by_rand_prob=self.cfg.replace_by_rand_prob)

    def test_caption_tensorizer(self) -> CaptionTensorizer:
        max_od = self.cfg.max_seq_length - self.cfg.max_seq_a_length
        return CaptionTensorizer(
            self.tokenizer,
            max_seq_length=self.cfg.max_gen_length + max_od,
            max_seq_a_length=self.cfg.max_gen_length,
            is_train=False)

    @property
    def vinvl_vocab(self) -> Dict[str, Any]:
        """{'label_to_idx', 'idx_to_label'} from cfg.tokenizer_file
        (reference tag_tokenizer, yaml/vinvl_label.json)."""
        path = self.cfg.get("tokenizer_file") or \
            asset_path("vinvl_label.json")
        with open(resolve_asset(path)) as f:
            return json.load(f)

    def tagger_tensorizer(self):
        if self.cfg.category == "vinvl":
            from ..data.tensorizers import VinvlTaggerTensorizer
            return VinvlTaggerTensorizer(
                self.vinvl_vocab["label_to_idx"],
                threshold=self.cfg.od_label_conf)
        return CaptionTaggerTensorizer(
            self.tokenizer, threshold=self.cfg.od_label_conf,
            category=self.cfg.category, encode=self.cfg.encode)

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------

    def get_len_dataset(self, is_train: bool):
        if is_train:
            return CaptionIdxTSVDataset(
                self.cfg.data, "train",
                caption_version=self.cfg.caption_version,
                data_root=self.cfg.data_root)
        return ImageIdxTSVDataset(self.cfg.test_data, self.cfg.test_split,
                                  data_root=self.cfg.data_root)

    def get_transform(self, is_train: bool):
        data = self.cfg.data if is_train else self.cfg.test_data
        split = "train" if is_train else self.cfg.test_split
        root = self.cfg.data_root
        # image feed layout:
        #   uint8 (default) — raw HWC bytes to the device; normalization
        #     folds into the patch projection (layers.py patch_embed);
        #   patchified — host normalize + space-to-depth (float32 feed),
        #     also `prepatchify: 1`;
        #   hwc_float — host normalize only (`prepatchify: 0`).
        feed = self.cfg.get("image_feed")
        if feed is None:
            pp = self.cfg.get("prepatchify")
            feed = "uint8" if pp is None else \
                ("patchified" if pp in (True, 1) else "hwc_float")
        patch = self.model_cfg.patch_size if feed == "patchified" else 0
        u8 = feed == "uint8"
        if is_train:
            img_t = TrainImageTransform(
                crop_size=self.cfg.train_crop_size,
                small_scale=self.cfg.input_small_scale,
                patchify=patch, emit_uint8=u8)
        else:
            img_t = TestImageTransform(
                crop_size=self.cfg.test_crop_size,
                crop_pct=self.cfg.crop_pct,
                patchify=patch, emit_uint8=u8,
                backend=self.cfg.get("image_backend") or "native",
                fast_decode=bool(self.cfg.get("image_fast_decode")))
        ops = [LoadHW(data, split, data_root=root),
               LoadImage(data, split, image_transform=img_t, data_root=root)]
        if is_train:
            ops.append(LoadCaption(data, split,
                                   version=self.cfg.caption_version,
                                   data_root=root))
            if self.cfg.encode == "precomputed":
                from ..data.dataset import LoadCaptionTags
                ops.append(LoadCaptionTags(data, split,
                                           version=self.cfg.caption_version,
                                           data_root=root))
            ops.append(LoadLabel(data, split,
                                 version=self.cfg.train_label_version,
                                 data_root=root))
        # live reference: IdentifyTextAB(False, ...) -> text_b always empty
        ops.append(IdentifyTextAB(False, self.cfg.od_label_conf,
                                  label_sort_by_conf=not
                                  self.cfg.no_sort_by_conf,
                                  unique_labels_on=self.cfg.unique_labels_on))
        tensorizer = (self.train_caption_tensorizer() if is_train
                      else self.test_caption_tensorizer())
        ops.append(TransCaptionTensorizer(
            tensorizer, real_text_a_in_test=self.cfg.real_text_a_in_test))
        if is_train:
            ops.append(TagTensorize(self.tagger_tensorizer()))
        # NOTE: 'label' is kept — TagTensorize overwrote the raw od list
        # with the multi-hot tensor (reference useless_keys comment out
        # 'label' for train, …bertemb.py:462)
        useless = ["idx", "idx_cap", "caption", "caption_tags", "text_a",
                   "text_b", "height", "width"]
        if not (is_train and self.cfg.scst):
            useless.append("idx_img")   # scst needs it for GT-caption lookup
        ops.append(RemoveUselessKeys(useless))
        ops.append(RenameKey({"segment_ids": "token_type_ids"}))
        return Compose(ops)

    # ------------------------------------------------------------------
    # train
    # ------------------------------------------------------------------

    def train(self):
        if self.cfg.scst:
            return self._train_scst()
        return self._train_xe()

    def _train_hyper(self):
        from ..solver.train_step import TrainHyper
        return TrainHyper(
            base_lr=float(self.cfg.base_lr),
            weight_decay=float(self.cfg.weight_decay),
            lr_multiplier=float(self.cfg.lr_multiplier),
            warmup_steps=int(self.cfg.warmup_steps),
            max_iter=self.max_iter,
            scheduler_type=self.cfg.scheduler_type,
            grad_clip=float(self.cfg.gradient_clip))

    def _train_state(self, ckpt, init_tag_blocks: bool):
        """(TrainState, start iteration): random weights from random_seed,
        then the last snapshot (weights, moments, generator) or the
        basemodel's weights; a fresh XE run copies the last trunk blocks
        into the tag branch (reference …bertemb.py:265-267).  Every rank
        then takes rank 0's parameters.  The dropout generator is seeded
        from (random_seed, rank); a snapshot holds rank 0's, so after a
        resume the other ranks seed theirs from the iteration too."""
        from ..models import vitcap as M
        from ..solver.checkpointing import restore_train_state
        from ..solver.train_step import init_train_state
        cfg, dev = self.model_cfg, self.device
        seed = int(self.cfg.random_seed)
        model = M.init_params(cfg, torch.Generator().manual_seed(seed),
                              device=dev)
        model, snap, start_iter = ckpt.recover_or_load(self.cfg.basemodel,
                                                       model)
        gen = torch.Generator(device=dev).manual_seed(
            rank_seed(seed, self.mpi_rank))
        if snap is not None:
            state = restore_train_state(snap, model, gen)
            if self.mpi_rank > 0:
                gen.manual_seed(rank_seed(seed, self.mpi_rank, start_iter))
        else:
            if init_tag_blocks:
                M.init_tag_blocks_from_encoder(model, cfg)
            state = init_train_state(model, gen)
        replicate_params(state.model)
        return state, start_iter

    def _train_xe(self):
        from ..solver.checkpointing import Checkpointer
        from ..solver.train_step import make_train_step

        ckpt = Checkpointer(self.model_folder)
        state, start_iter = self._train_state(ckpt, init_tag_blocks=True)
        step_fn = make_train_step(self.model_cfg, self._train_hyper())
        loader = self.get_data_loader(is_train=True, start_iter=start_iter)

        meters = MetricLogger()
        self.train_meters = meters
        iteration = start_iter
        t_end = time.time()
        log_step = int(self.cfg.log_step)
        # finiteness-probe cadence; defaults to log_step (the reference
        # checks every iteration, trainer.py:134 — each check is a host
        # sync, so the cadence is a config knob)
        nan_check_steps = int(self.cfg.get("nan_check_steps") or log_step)
        snapshot_steps = int(self.cfg.snapshot_steps)
        gen_tag_ratio = self.cfg.get("gen_tag_ratio")
        if self.cfg.get("gt_tag_train"):
            gen_tag_ratio = 0.05           # reference …bertemb.py:95-96
        elif self.cfg.get("pred_tag_train"):
            gen_tag_ratio = 1.0

        # preemption-safe shutdown: a caught SIGTERM requests one final
        # snapshot + clean loop exit so recover_or_load resumes from the
        # exact iteration (the reference snapshots on a step cadence only,
        # trainer.py:177-185)
        preempted = {"flag": False}

        def _on_sigterm(signum, frame):
            preempted["flag"] = True
            logging.warning("SIGTERM: will snapshot and exit at the next "
                            "step boundary")
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:                 # non-main thread: skip
            prev_handler = None

        # host batches are prefetched by the thread-pool DataLoader; the
        # host->device copy and the step's launches are asynchronous, so
        # host prep of batch N+1 overlaps device compute of batch N
        try:
            for batch in loader:
                data_time = time.time() - t_end
                dev = self._device_train_batch(batch)
                if gen_tag_ratio is not None:
                    # linear ramp to 1.0 over training (…bertemb.py:99-101)
                    dev["gen_tag_ratio"] = max(float(gen_tag_ratio),
                                               iteration / self.max_iter)
                # the train-time probes only for steps whose metrics get
                # read — log/NaN-check/final
                it_next = iteration + 1
                want_probes = (it_next % log_step == 0
                               or it_next % nan_check_steps == 0
                               or it_next >= self.max_iter)
                state, metrics = step_fn(state, dev, want_probes)
                iteration += 1
                if iteration % nan_check_steps == 0 \
                        and iteration % log_step != 0 \
                        and iteration != self.max_iter:
                    if not np.isfinite(float(metrics["loss"])):
                        ckpt.save_tagged(f"NaN_context_{self.mpi_rank}",
                                         iteration, state)
                        raise RuntimeError(f"NaN loss at iter {iteration}")
                if iteration % log_step == 0 or iteration == self.max_iter:
                    m = {k: float(v) for k, v in metrics.items()}
                    if not np.isfinite(m["loss"]):
                        # tagged artifact; last_checkpoint keeps pointing
                        # at the last healthy snapshot (reference
                        # trainer.py:134-137 NaN_context semantics)
                        ckpt.save_tagged(f"NaN_context_{self.mpi_rank}",
                                         iteration, state)
                        raise RuntimeError(
                            f"NaN loss at iter {iteration}: {m}")
                    step_time = time.time() - t_end
                    meters.update(loss=m["loss"], data=data_time,
                                  time=step_time)
                    eta = (self.max_iter - iteration) \
                        * meters.time.global_avg
                    logging.info(
                        "iter %d/%d %s lr_mult %.4f acc %.3f eta %.0fs",
                        iteration, self.max_iter, meters,
                        m.get("lr_mult", 0), m.get("caption_acc", 0), eta)
                if iteration % snapshot_steps == 0 \
                        and iteration != self.max_iter and self.mpi_rank == 0:
                    ckpt.save(iteration, state)
                t_end = time.time()
                # with more than one rank the stop is collective (a rank
                # that left would hang its peers in the next all-reduce):
                # the flag is OR-ed over the ranks every preempt_sync_steps
                # (default log_step) iterations, the same iterations on
                # every rank, and a SIGTERM between waits for the next
                stop = preempted["flag"]
                if self.mpi_size > 1:
                    sync_every = int(self.cfg.get("preempt_sync_steps")
                                     or log_step)
                    if iteration % sync_every == 0:
                        stop = any_process(stop)
                        preempted["flag"] = stop
                    else:
                        stop = False
                if stop and iteration < self.max_iter:
                    if self.mpi_rank == 0:
                        ckpt.save(iteration, state)
                    self._barrier()
                    logging.warning("preemption snapshot at iter %d "
                                    "written; exiting train loop",
                                    iteration)
                    break
                if iteration >= self.max_iter:
                    break
            # a completed run always writes its final checkpoint, even if
            # the SIGTERM landed after the last step
            if preempted["flag"] and iteration < self.max_iter:
                raise SystemExit(143)         # standard SIGTERM exit status
            if self.mpi_rank == 0:
                ckpt.save(self.max_iter, state)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        return state

    def _train_scst(self):
        """SCST fine-tuning loop (reference …expanding.py:404-478): greedy
        baseline + sampled decode, CIDEr-D advantage on the host,
        policy-gradient step on the device."""
        from ..solver.checkpointing import Checkpointer
        from ..solver.scst import (ScstConfig, ScstReward, make_scst_fns,
                                   scst_train_step)

        ckpt = Checkpointer(self.model_folder)
        state, start_iter = self._train_state(ckpt, init_tag_blocks=False)
        opts = self.decode_options()
        scfg = ScstConfig(num_return=int(self.cfg.scst_num_return),
                          baseline_type=self.cfg.sc_baseline_type,
                          cider_cached_tokens=self.cfg.cider_cached_tokens,
                          visual_token_ratio=float(
                              self.cfg.get("random_token_sample") or 1.0))
        decode_fn, grad_fn = make_scst_fns(self.model_cfg, opts, scfg,
                                           self._train_hyper())
        df = self.cfg.cider_cached_tokens
        reward = ScstReward(
            df if df and op.isfile(df) else "corpus",
            baseline_type=self.cfg.sc_baseline_type)
        caption_loader = LoadCaption(self.cfg.data, "train",
                                     version=self.cfg.caption_version,
                                     data_root=self.cfg.data_root)
        loader = self.get_data_loader(is_train=True, start_iter=start_iter)

        A = opts.max_length
        dev = self.device
        meters = MetricLogger()
        self.train_meters = meters
        iteration = start_iter
        sample_gen = torch.Generator(device=dev).manual_seed(rank_seed(
            int(self.cfg.random_seed) + 1, self.mpi_rank))
        t_end = time.time()
        for batch in loader:
            data_time = time.time() - t_end
            input_ids = np.asarray(batch["input_ids"])
            dev_batch = {
                "image": self._to_device_image(batch["image"]),
                "od_ids": torch.from_numpy(
                    input_ids[:, A:].astype(np.int64)).to(dev),
                "seq_len": torch.from_numpy(np.asarray(
                    batch["seq_len"]).astype(np.int64)).to(dev),
            }
            gt = [caption_loader.get_captions_by_key(int(i))
                  for i in batch["idx_img"]]
            state, metrics = scst_train_step(
                decode_fn, grad_fn, reward, self.tokenizer, state,
                dev_batch, gt, sample_gen)
            iteration += 1
            if iteration % int(self.cfg.log_step) == 0 \
                    or iteration == self.max_iter:
                loss = float(metrics["scst_loss"])
                if not np.isfinite(loss):
                    ckpt.save_tagged(f"NaN_context_{self.mpi_rank}",
                                     iteration, state)
                    raise RuntimeError(f"NaN scst loss at iter {iteration}")
                meters.update(scst_loss=loss, cider=metrics["cider_score"],
                              data=data_time, time=time.time() - t_end)
                logging.info("scst iter %d/%d %s", iteration, self.max_iter,
                             meters)
            if iteration % int(self.cfg.snapshot_steps) == 0 \
                    and iteration != self.max_iter and self.mpi_rank == 0:
                ckpt.save(iteration, state)
            t_end = time.time()
            if iteration >= self.max_iter:
                break
        if self.mpi_rank == 0:
            ckpt.save(self.max_iter, state)
        return state

    def _to_device_image(self, v) -> torch.Tensor:
        a = np.asarray(v)
        # uint8 feeds stay uint8 (normalization folds into the patch
        # projection on device); float feeds go up to f32
        if a.dtype != np.uint8:
            a = a.astype(np.float32, copy=False)
        return torch.from_numpy(a).to(self.device)

    def _device_train_batch(self, batch) -> Dict[str, torch.Tensor]:
        dev = {"image": self._to_device_image(batch["image"])}
        for k in ["input_ids", "token_type_ids", "seq_a_len", "seq_len",
                  "masked_pos", "masked_ids", "label"]:
            a = np.asarray(batch[k])
            if a.dtype.kind in "iu":
                a = a.astype(np.int64)
            dev[k] = torch.from_numpy(a).to(self.device)
        return dev

    # ------------------------------------------------------------------
    # predict
    # ------------------------------------------------------------------

    def decode_options(self):
        from ..models.decode import DecodeOptions
        return DecodeOptions(
            max_length=int(self.cfg.max_gen_length),
            num_beams=int(self.cfg.num_beams),
            num_keep_best=1,
            do_sample=bool(self.cfg.do_sample),
            temperature=float(self.cfg.temperature),
            top_k=int(self.cfg.top_k),
            top_p=float(self.cfg.top_p),
            length_penalty=float(self.cfg.length_penalty),
            repetition_penalty=float(self.cfg.repetition_penalty),
            od_labels_start_posid=int(self.cfg.max_seq_a_length))

    def load_test_model(self, model_file: str):
        """The model of a snapshot (`.ckpt`, or a port state dict) or of a
        reference `.pt`/`.pth` through the bridge (its missing names keep
        init_params' values), on the pipeline's device.  A snapshot is
        memory-mapped, so its optimizer moments are never read."""
        from ..models import vitcap as M
        cfg, dev = self.model_cfg, self.device
        if model_file.endswith((".pt", ".pth")):
            from ..solver.checkpoint_bridge import (load_params_from_torch,
                                                    load_torch_state_dict)
            model = M.init_params(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
            load_params_from_torch(model, load_torch_state_dict(model_file))
            return model
        state = torch.load(model_file, map_location="cpu", mmap=True,
                           weights_only=True)
        model = M.ViTCAP(cfg, device="meta").to_empty(device=dev)
        model.load_state_dict(state["model"] if "model" in state else state,
                              strict=True)
        return model.requires_grad_(False)

    def _make_cbs_decoder(self):
        from ..models.cbs import (CbsDecoder, ConstraintBoxesReader,
                                  ConstraintFilter, FiniteStateMachineBuilder,
                                  load_wordforms)
        return CbsDecoder(
            self.tokenizer,
            ConstraintFilter(self.cfg.cbs_hierarchy_json,
                             float(self.cfg.cbs_nms_threshold),
                             int(self.cfg.cbs_max_constraints)),
            FiniteStateMachineBuilder(
                self.tokenizer,
                load_wordforms(self.cfg.cbs_constraint2tokens_tsv),
                load_wordforms(self.cfg.cbs_wordforms_tsv),
                int(self.cfg.cbs_max_constraints)),
            ConstraintBoxesReader(self.cfg.cbs_boxes_tsv),
            min_constraints_to_satisfy=int(
                self.cfg.min_constraints_to_satisfy),
            beam_size=max(int(self.cfg.num_beams), 5),
            # the sparse-FSM search is the production default (few-KB
            # descriptors against a 31 MB dense adjacency an image);
            # cbs_sparse: 0 takes the dense search
            sparse=str(self.cfg.get("cbs_sparse") or "1") != "0")

    def _results(self, keys, ids, confs) -> Iterator:
        """(key, JSON list of {caption, conf}) rows of a drained batch."""
        for key, caps, cfs in zip(keys, ids, confs):
            res = [{"caption": self.tokenizer.decode(
                        c.tolist(), skip_special_tokens=True),
                    "conf": float(cf)}
                   for c, cf in zip(caps, cfs)]
            yield key, json.dumps(res)

    def predict_iter(self, dataloader, model, meters) -> Iterator:
        from ..models import decode as D
        from ..models.cbs import put
        cfg = self.model_cfg
        opts = self.decode_options()
        A = opts.max_length
        gen = torch.Generator(device=self.device).manual_seed(
            rank_seed(int(self.cfg.random_seed) + 7, self.mpi_rank))
        cbs = self._make_cbs_decoder() if self.cfg.use_cbs else None

        B = int(self.cfg.test_batch_size)
        n_done = 0
        # one-batch software pipeline: launch batch i+1's decode BEFORE
        # reading batch i's ids back, so host-side tokenizer decode + input
        # prep (and with CBS the FSM build) overlap device compute (the
        # launches are asynchronous; the ids stay on the card until the
        # drain)
        pending = None    # (keys, n, device out, n_cons or None, t_disp)

        def drain(p):
            keys, n, out, n_cons, t_disp = p
            if cbs is not None:
                best, best_lp = cbs.collect(out, n_cons, cfg)
                ids, confs = best[:n, None, :], np.exp(best_lp)[:n, None]
            else:
                ids = out[0][:n].cpu().numpy()
                confs = np.exp(out[1][:n].float().cpu().numpy())
            # dispatch -> fetch-complete: device decode PLUS the
            # overlapped host prep/dispatch of the next batch, hence the
            # meter is named pipeline_time, not decode_time
            meters.update(pipeline_time=time.time() - t_disp)
            yield from self._results(keys[:n], ids, confs)

        for batch in dataloader:
            t0 = time.time()
            images = np.asarray(batch["image"])
            if images.dtype != np.uint8:
                images = images.astype(np.float32, copy=False)
            input_ids = np.asarray(batch["input_ids"])
            tt = np.asarray(batch["token_type_ids"])
            seq_len = np.asarray(batch["seq_len"])
            n = images.shape[0]
            if n < B:        # pad the ragged tail to test_batch_size
                pad = B - n
                images = np.concatenate(
                    [images, np.repeat(images[-1:], pad, 0)])
                input_ids = np.concatenate(
                    [input_ids, np.repeat(input_ids[-1:], pad, 0)])
                tt = np.concatenate([tt, np.repeat(tt[-1:], pad, 0)])
                seq_len = np.concatenate(
                    [seq_len, np.repeat(seq_len[-1:], pad, 0)])
            keys = list(batch["key"])
            # pinned, non-blocking copies: this batch's host work (with CBS
            # its FSM build) overlaps the previous batch's decode
            args = [put(a, self.device) for a in
                    (images, input_ids[:, A:], tt[:, A:], seq_len)]
            if cbs is not None:
                # the last batch padded with its last key, as its images
                out, n_cons = cbs.dispatch(model, *args,
                                           keys + keys[-1:] * (B - n), cfg,
                                           opts)
            else:
                res = D.generate(model, *args, cfg, opts, rng=gen)
                out, n_cons = (res["ids"], res["logprobs"]), None
                if n_done == 0 and str(self.cfg.get("speed_breakdown")
                                       or "0") != "0":
                    self._measure_speed_breakdown(model, *args, cfg, opts)
            if pending is not None:
                yield from drain(pending)
            pending = (keys, n, out, n_cons, t0)
            meters.update(prep_time=time.time() - t0)
            n_done += 1
            if self.cfg.test_max_iter is not None \
                    and n_done >= int(self.cfg.test_max_iter):
                break
        if pending is not None:
            yield from drain(pending)

    def _measure_speed_breakdown(self, model, images, od_ids, tt_od,
                                 seq_len, cfg, opts) -> None:
        """Per-stage device-time table for the `.speed.yaml` (the
        reference's per-module ForwardPassTimeChecker table,
        forward_pass_time_checker.py:20-72): encode (vision trunk + tag
        branch + tag logits), context build (+ tag select, text embed and
        the decoder's K/V prefill) and the full generate; the decode loop
        is the difference.  On the card each is timed with CUDA events
        after a synchronise, the mean of 3 runs after a warm-up; on the
        CPU with the host clock."""
        from ..models import decode as D
        from ..models import vitcap as M
        cuda = images.device.type == "cuda"

        def timeit(fn, iters=3):
            fn()                                   # warm-up
            if cuda:
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(iters):
                    fn()
                t1.record()
                torch.cuda.synchronize()
                return t0.elapsed_time(t1) / 1e3 / iters
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) / iters

        with torch.inference_mode():
            t_enc = timeit(lambda: M.encode_images(model, images, cfg))
            t_ctx = timeit(lambda: D.build_decode_context(
                model, images, od_ids, tt_od, seq_len, cfg, opts))
            t_full = timeit(lambda: D.generate(
                model, images, od_ids, tt_od, seq_len, cfg, opts,
                rng=torch.Generator(device=images.device).manual_seed(0)))
        B = int(images.shape[0])
        n_blocks = int(cfg.num_hidden_layers) + int(cfg.split_blocks)
        self.speed_info = {
            "batch_size": B,
            "clock": "cuda events" if cuda else "host",
            # vision trunk + tag branch + tag logits (encode_images)
            "vision_tags_ms": round(t_enc * 1e3, 3),
            "vision_per_block_ms": round(t_enc * 1e3 / max(n_blocks, 1), 3),
            # tag select + text embed + decoder K/V prefill
            "prefill_ms": round(max(t_ctx - t_enc, 0.0) * 1e3, 3),
            "decode_scan_ms": round(max(t_full - t_ctx, 0.0) * 1e3, 3),
            "decode_per_step_ms": round(
                max(t_full - t_ctx, 0.0) * 1e3
                / max(int(cfg.max_seq_a_len) - 1, 1), 3),
            "full_generate_ms": round(t_full * 1e3, 3),
            "device_caps_per_s": round(B / t_full, 2),
        }

    # ------------------------------------------------------------------
    # evaluate
    # ------------------------------------------------------------------

    def evaluate(self, predict_file: str, evaluate_file: str):
        from ..data.tsv import TSVDataset, iter_caption_to_json, tsv_reader
        from ..evals.coco_eval import evaluate_on_coco_caption
        ds = TSVDataset(self.cfg.test_data, data_root=self.cfg.data_root)
        gt_tsv = ds.get_data(self.cfg.test_split, "caption")
        json_caption = op.splitext(gt_tsv)[0] + ".coco_format.json"
        if not op.isfile(json_caption):
            iter_caption_to_json(tsv_reader(gt_tsv), json_caption)
        result = evaluate_on_coco_caption(predict_file, json_caption,
                                          outfile=evaluate_file)
        logging.info("evaluation result: %s", result)
        return result
