"""Distill a teacher checkpoint into a student through the finetune loop
(counterpart of run_distill.py).

    python -m bert_pytorch_tpu_torch.run_distill --task classify \\
        --student student_6l_768 --teacher_checkpoint teacher_out/ckpt \\
        --train_file pairs.tsv --test_file test.tsv \\
        --model_config_file configs/bert_large_uncased_config.json \\
        --vocab_file vocab.txt --output_dir student_out \\
        --packing --alpha_hidden 1.0 [--device cpu]

`--task` names any registered task (`--list_tasks` prints them);
`--student` a `student_<L>l_<H>` preset (config.student_config) or a
BertConfig JSON path; the rest of the CLI is the task's own parser, whose
--model_config_file is the teacher's. The run is
training/finetune.run_task with the task's loss replaced by
training/distill.py's KD + hard + layer-matched tap mix; the teacher is
restored from a port checkpoint (`<dir>[@step]`, a finetune run's
`<output_dir>/ckpt`) with the serving restore's strictness, and runs
under torch.no_grad() inside the same step. Runs on CUDA unless --device
cpu.

In --output_dir: the student checkpoint (`ckpt/`, which run_server serves
with the student's config), the student's `model_config.json` (what
run_server needs), and `distill_summary.json`: the student's and the
teacher's eval results, the accuracy delta, the logged train-loss
trajectory.

`--inject broken_student` (a negative control): evaluate a fresh random
student instead of the trained one, so the accuracy delta must grow.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, Optional


def _distill_parser() -> argparse.ArgumentParser:
    listing = "--list_tasks" in sys.argv
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--task", default=None,
                   help="registered task to distill (see --list_tasks)")
    p.add_argument("--student", required=not listing,
                   help="student preset (student_<L>l_<H>) or a BertConfig "
                        "JSON path")
    p.add_argument("--teacher_checkpoint", required=not listing,
                   help="teacher checkpoint dir (or dir@step)")
    p.add_argument("--distill_temperature", type=float, default=2.0)
    p.add_argument("--alpha_kd", type=float, default=1.0,
                   help="soft-target KL weight")
    p.add_argument("--alpha_ce", type=float, default=0.5,
                   help="hard-label task-loss weight")
    p.add_argument("--alpha_hidden", type=float, default=0.0,
                   help="layer-matched mlp_out MSE weight")
    p.add_argument("--alpha_attn", type=float, default=0.0,
                   help="layer-matched attention_out MSE weight")
    p.add_argument("--distill_layer_map", default=None,
                   help="'s:t,s:t,...' student<-teacher layer pairs "
                        "(default: evenly spaced)")
    p.add_argument("--inject", choices=["broken_student"], default=None,
                   help="fault injection for negative controls")
    return p


def main(argv=None, log: Callable[[str], None] = print,
         trace: Optional[Dict] = None) -> dict:
    """The run; returns the summary. `trace`, when given, receives
    run_task's internals and `teacher`, the teacher module."""
    argv = list(sys.argv[1:] if argv is None else argv)

    from bert_pytorch_tpu_torch.tasks import registry

    if "--list_tasks" in argv:
        for name in registry.all_tasks():
            spec = registry.get(name)
            log(f"{name}: {spec.title} [{spec.head}, metric {spec.metric}]")
        return {}

    dargs, rest = _distill_parser().parse_known_args(argv)
    if not dargs.task:
        raise SystemExit("--task <name> is required; registered tasks: "
                         + ", ".join(registry.all_tasks()))
    try:
        base_spec = registry.get(dargs.task)
    except KeyError as e:
        raise SystemExit(str(e)) from None
    args = base_spec.parse_arguments(rest)
    trace = {} if trace is None else trace
    # facts made inside setup (which run_task owns) for the summary
    shared: Dict = {}

    def distill_setup(args, config, device, log, record):
        import torch

        from bert_pytorch_tpu_torch.config import BertConfig, student_config
        from bert_pytorch_tpu_torch.models.bert import init_weights
        from bert_pytorch_tpu_torch.training import distill
        from bert_pytorch_tpu_torch.telemetry.stepwatch import flops_per_seq
        from bert_pytorch_tpu_torch.training.checkpoint import (
            load_params, model_params_only, strict_load_state)

        teacher_cfg = config
        if dargs.student.endswith(".json"):
            student_cfg = BertConfig.from_json_file(dargs.student).replace(
                vocab_size=teacher_cfg.vocab_size)
        else:
            student_cfg = student_config(dargs.student, teacher_cfg)

        t_run = base_spec.setup(args, teacher_cfg, device, log, record)
        s_run = base_spec.setup(args, student_cfg, device, log, record)

        teacher = t_run.model
        state, teacher_step = load_params(dargs.teacher_checkpoint, log=log)
        strict_load_state(teacher, model_params_only(state))
        del state
        teacher.requires_grad_(False).eval()
        trace["teacher"] = teacher

        dcfg = distill.DistillConfig(
            temperature=dargs.distill_temperature,
            alpha_kd=dargs.alpha_kd, alpha_ce=dargs.alpha_ce,
            alpha_hidden=dargs.alpha_hidden, alpha_attn=dargs.alpha_attn,
            layer_map=distill.parse_layer_map(
                dargs.distill_layer_map, student_cfg.num_hidden_layers,
                teacher_cfg.num_hidden_layers),
            max_segments=getattr(args, "packing_max_segments", 8))
        log(f"distill[{base_spec.name}]: teacher "
            f"{teacher_cfg.num_hidden_layers}L/{teacher_cfg.hidden_size}H "
            f"@{dargs.teacher_checkpoint} step {teacher_step} -> student "
            f"{student_cfg.num_hidden_layers}L/{student_cfg.hidden_size}H "
            f"({dargs.student}), T={dcfg.temperature}, layer map "
            f"{list(dcfg.layer_map)}")

        common = dict(teacher_model=teacher, dcfg=dcfg,
                      output_kind=base_spec.output_kind,
                      label_ignore=s_run.label_ignore)
        proj = distill.init_projections(
            torch.Generator(device=device).manual_seed(args.seed + 0x5D15),
            dcfg, student_cfg, teacher_cfg, device=device)
        base_finalize = s_run.finalize

        def finalize(results):
            student = s_run.model
            kept = None
            if dargs.inject == "broken_student":
                log("distill: INJECTED broken_student — evaluating a fresh "
                    "random student")
                kept = {k: v.detach().clone()
                        for k, v in student.state_dict().items()}
                init_weights(student, torch.Generator(
                    device=device).manual_seed(args.seed + 1317),
                    std=student_cfg.initializer_range)
            try:
                out = dict(base_finalize(results) or {}
                           if base_finalize is not None else {})
            finally:
                if kept is not None:
                    student.load_state_dict(kept)
            if t_run.finalize is not None:
                t_out = t_run.finalize({}) or {}
                out.update({f"teacher_{k}": v for k, v in t_out.items()})
            if "test_accuracy" in out and "teacher_test_accuracy" in out:
                out["accuracy_delta"] = (out["teacher_test_accuracy"]
                                         - out["test_accuracy"])
            out["teacher_checkpoint_step"] = teacher_step
            return out

        # the student's serving config: run_server needs the student's
        # depth and width, not the teacher's --model_config_file
        cfg_path = os.path.join(args.output_dir, "model_config.json")
        with open(cfg_path, "w", encoding="utf-8") as f:
            f.write(student_cfg.replace(debug_taps=False).to_json_string())
        shared.update(student_config=cfg_path,
                      student_layers=student_cfg.num_hidden_layers,
                      student_hidden=student_cfg.hidden_size,
                      teacher_layers=teacher_cfg.num_hidden_layers,
                      teacher_hidden=teacher_cfg.hidden_size,
                      layer_map=[list(p) for p in dcfg.layer_map],
                      projections=distill.projected_layers(proj))

        return dataclasses.replace(
            s_run,
            loss_builder=distill.make_distill_loss_builder(
                packed=False, **common),
            packed_loss_builder=distill.make_distill_loss_builder(
                packed=True, **common),
            finalize=finalize, extra_params=proj,
            # a row's work: the student's forward and backward and the
            # teacher's forward (a third of its forward + backward)
            flops_per_row=(
                flops_per_seq(student_cfg, s_run.seq_len,
                              student_cfg.vocab_size, 0)
                + flops_per_seq(teacher_cfg, s_run.seq_len,
                                teacher_cfg.vocab_size, 0) / 3.0))

    spec = dataclasses.replace(base_spec, setup=distill_setup)

    from bert_pytorch_tpu_torch.training.finetune import run_task

    results = run_task(spec, args, log=log, trace=trace)

    # the train-loss trajectory from the run's jsonl
    prefix = getattr(args, "log_prefix", None) or f"{spec.name}_log"
    train_losses = []
    try:
        with open(os.path.join(args.output_dir, f"{prefix}.jsonl"),
                  encoding="utf-8") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("tag") == "train" and "loss" in rec:
                    train_losses.append(float(rec["loss"]))
    except OSError:
        pass

    summary = {
        "kind": "distill_run",
        "task": dargs.task,
        "student": dargs.student,
        "teacher_checkpoint": dargs.teacher_checkpoint,
        "temperature": dargs.distill_temperature,
        "alpha_kd": dargs.alpha_kd, "alpha_ce": dargs.alpha_ce,
        "alpha_hidden": dargs.alpha_hidden,
        "alpha_attn": dargs.alpha_attn,
        "inject": dargs.inject,
        "train_losses": train_losses,
        "loss_first": train_losses[0] if train_losses else None,
        "loss_last": train_losses[-1] if train_losses else None,
        **shared,
        **{k: v for k, v in results.items()
           if isinstance(v, (int, float, str))},
    }
    out_path = os.path.join(args.output_dir, "distill_summary.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=1, sort_keys=True)
        f.write("\n")
    log(f"distill: summary -> {out_path}")
    return summary


if __name__ == "__main__":
    main()
