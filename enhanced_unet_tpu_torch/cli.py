"""The command line, ported from `enhanced_unet_tpu/cli.py`.

    python -m enhanced_unet_tpu_torch.cli --mode train_eval --models unet enhanced_unet

The reference's main.py:74-449: the modes train / eval / train_eval /
visualize (and predict, manifest), the same flags and defaults, a loop over
the models in which one model's failure is recorded as zeros and the next
one runs, `results/evaluation_results.{json,csv}` (the CSV with the
reference's Chinese headers, main.py:256-276) and the comparison figures.

Everything runs on the CUDA card; `main(device="cpu")` runs on the CPU (the
tests).  `--num-devices N` trains on N cards, one process per card, which
`train_model` starts; under `torchrun --nproc_per_node N ... --distributed`
each process is one rank, rank 0 alone evaluates and writes the results,
and there a model's failure ends the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
from typing import Dict, Optional, Union

import torch

ZERO_RESULTS = {
    "sem_mean_iou": 0.0, "sem_mean_dice": 0.0,
    "sem_live_iou": 0.0, "sem_live_dice": 0.0,
    "sem_dead_iou": 0.0, "sem_dead_dice": 0.0,
    "live_iou": 0.0, "live_precision": 0.0, "live_recall": 0.0,
    "dead_iou": 0.0, "dead_precision": 0.0, "dead_recall": 0.0,
    "viability_accuracy": 0.0, "bbox_mAP": 0.0, "segm_mAP": 0.0,
}

# the reference's CSV schema (main.py:256-276), byte for byte
CSV_COLUMNS = [
    ("模型", None),
    ("语义分割 mIoU", "sem_mean_iou"),
    ("语义分割 mDice", "sem_mean_dice"),
    ("语义分割-背景 IoU", "sem_background_iou"),
    ("语义分割-背景 Dice", "sem_background_dice"),
    ("语义分割-活细胞 IoU", "sem_live_iou"),
    ("语义分割-死细胞 IoU", "sem_dead_iou"),
    ("语义分割-活细胞 Dice", "sem_live_dice"),
    ("语义分割-死细胞 Dice", "sem_dead_dice"),
    ("实例分割-活细胞 IoU", "live_iou"),
    ("实例分割-死细胞 IoU", "dead_iou"),
    ("活细胞检测准确率 (Precision)", "live_precision"),
    ("死细胞检测准确率 (Precision)", "dead_precision"),
    ("活细胞召回率 (Recall)", "live_recall"),
    ("死细胞召回率 (Recall)", "dead_recall"),
    ("细胞活力准确率", "viability_accuracy"),
    ("bbox mAP", "bbox_mAP"),
    ("segm mAP", "segm_mAP"),
]


def write_results_csv(all_results: Dict[str, Dict], path: str) -> None:
    """One row per model under `CSV_COLUMNS`, a missing key as 0.0, in
    UTF-8 with a byte-order mark (as the reference writes it)."""
    import csv

    with open(path, "w", newline="", encoding="utf-8-sig") as f:
        w = csv.writer(f)
        w.writerow([c for c, _ in CSV_COLUMNS])
        for model_name, r in all_results.items():
            w.writerow([model_name] + [r.get(key, 0.0) for _, key in CSV_COLUMNS[1:]])


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Cell viability assessment (Enhanced-UNet, PyTorch/CUDA)")
    parser.add_argument(
        "--mode", type=str, default="train_eval",
        choices=["train", "eval", "train_eval", "visualize", "predict", "manifest"])
    parser.add_argument("--regenerate-predictions", action="store_true")
    parser.add_argument(
        "--models", type=str, nargs="+",
        default=["segnet", "unet", "enhanced_unet", "fcn", "pspnet", "linknet"])
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--data-dir", type=str, default="data")
    parser.add_argument("--results-dir", type=str, default="results")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    parser.add_argument("--max-size", type=int, default=640)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument(
        "--num-devices", type=int, default=1,
        help="data-parallel cards for training, one process per card")
    parser.add_argument(
        "--distributed", action="store_true",
        help="run as one rank of a torchrun job: initialise torch.distributed from "
             "torchrun's environment (NCCL on the card)")
    parser.add_argument(
        "--tiled", action="store_true",
        help="full-resolution sliding-window tiled inference during eval (the "
             "reference downscales large images instead, dataset.py:143-158)")
    parser.add_argument("--tile", type=int, default=512)
    parser.add_argument("--overlap", type=int, default=64)
    parser.add_argument(
        "--eval-batch", type=int, default=1,
        help="batch the eval pipeline over same-shape image groups (1 = the "
             "reference's per-image loop; the same results)")
    parser.add_argument(
        "--serving-preset", choices=("exact", "optimized"), default="exact",
        help="eval/predict model placement: 'exact' is the reference's; "
             "'optimized' adds config.SERVING_OPTIMIZED_KWARGS (the same "
             "parameters and checkpoints)")
    parser.add_argument(
        "--pretrained-dir", type=str, default=None,
        help="directory of the ImageNet encoder files (convert/pretrained.py "
             "WEIGHT_MANIFEST; `--mode manifest` lists them); with --mode train, "
             "the encoders start from them, as the reference's "
             "encoder_weights='imagenet'")
    return parser


def main(argv=None, device: Optional[Union[str, torch.device]] = None) -> int:
    """Run the CLI on `argv` (default: `sys.argv[1:]`) on `device` (None:
    the CUDA card, raising without one); returns the exit code."""
    args = _parser().parse_args(argv)

    if args.mode == "manifest":
        # the weight files of the selected models
        from enhanced_unet_tpu_torch.convert.pretrained import required_weights

        for model_name in args.models:
            entries = required_weights(model_name)
            if not entries:
                print(f"{model_name}: trains from scratch (no pretrained "
                      "encoders in the reference)")
            for variant, e in entries.items():
                print(f"{model_name}: {variant}  file={e['file']}  "
                      f"sha256[:8]={e['sha256_prefix']}\n  url={e['url']}")
        return 0

    from enhanced_unet_tpu_torch.device import resolve_device
    from enhanced_unet_tpu_torch.parallel import make_mesh

    device = resolve_device(device)
    if not args.distributed:
        return _run(args, device)
    mesh = make_mesh(device=device)
    try:
        return _run(args, mesh.device, mesh)
    finally:
        torch.distributed.destroy_process_group()


def _run(args, device: torch.device, mesh=None) -> int:
    """The model loop on `device`; under `mesh` (a torchrun job) every rank
    trains, rank 0 alone does the rest, and the others wait for it after
    each model."""
    from enhanced_unet_tpu_torch.config import get_preset
    from enhanced_unet_tpu_torch.train import api
    from enhanced_unet_tpu_torch.viz import Visualizer

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    lead = mesh is None or mesh.rank == 0
    # in a torchrun job a failure ends the run: the other ranks would wait
    # for the one that failed.  `--num-devices N` alone is one process here,
    # where train_model's workers have all ended when it raises.
    isolate = mesh is None
    if lead:
        os.makedirs(args.results_dir, exist_ok=True)
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        print(f"mode: {args.mode}\nmodels: {args.models}\nepochs: {args.epochs}")

    def serving_cfg(model_name):
        # eval/predict-time config with the serving preset; None keeps the
        # entry points' own (the same for "exact")
        if args.serving_preset == "exact":
            return None
        cfg = get_preset(model_name, data_dir=args.data_dir)
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, serving_preset=args.serving_preset))

    all_results: Dict[str, Dict] = {}
    for model_name in args.models:
        try:
            if lead:
                print(f"\n{'=' * 60}\nProcessing: {model_name}\n{'=' * 60}")
            results = dict(ZERO_RESULTS)
            if args.mode == "visualize":
                if lead:
                    api.visualize_model(
                        model_name, data_dir=args.data_dir,
                        checkpoint_dir=args.checkpoint_dir, results_dir=args.results_dir,
                        regenerate_predictions=args.regenerate_predictions,
                        max_size=args.max_size, dtype=dtype, device=device)
            elif args.mode == "predict":
                # label-free serving over bare images (the reference's
                # eval needs labelme JSON beside each image)
                if lead:
                    api.predict_model(
                        model_name, images_dir=args.data_dir, results_dir=args.results_dir,
                        max_size=args.max_size, cfg=serving_cfg(model_name), dtype=dtype,
                        tiled=args.tiled, tile=args.tile, overlap=args.overlap,
                        batch_size=max(args.eval_batch, 1), device=device)
            else:
                checkpoint_path = None
                if args.mode in ("train", "train_eval"):
                    checkpoint_path = api.train_model(
                        model_name, data_dir=args.data_dir, num_epochs=args.epochs,
                        checkpoint_dir=args.checkpoint_dir, max_size=args.max_size,
                        dtype=dtype, num_devices=args.num_devices,
                        pretrained_dir=args.pretrained_dir, device=device)
                if args.mode in ("eval", "train_eval") and lead:
                    results = api.evaluate_model(
                        model_name, data_dir=args.data_dir, checkpoint_path=checkpoint_path,
                        results_dir=args.results_dir, max_size=args.max_size,
                        cfg=serving_cfg(model_name), dtype=dtype, tiled=args.tiled,
                        tile=args.tile, overlap=args.overlap,
                        eval_batch_size=args.eval_batch, device=device)
            if mesh is not None:
                mesh.barrier()      # rank 0's evaluation may outlast a collective's timeout
            all_results[model_name] = results

            if lead:
                print(f"\n{model_name} results:")
                for k in ("sem_mean_iou", "sem_mean_dice", "live_iou", "dead_iou",
                          "live_precision", "dead_precision", "viability_accuracy",
                          "bbox_mAP", "segm_mAP"):
                    print(f"  {k}: {results.get(k, 0.0):.4f}")
        except Exception as e:  # the reference goes on with the next model
            if not isolate:
                raise
            print(f"Model {model_name} failed: {e}")
            traceback.print_exc()
            all_results[model_name] = dict(ZERO_RESULTS)
    if not lead:
        return 0

    # the aggregate files (main.py:251-279)
    with open(os.path.join(args.results_dir, "evaluation_results.json"), "w",
              encoding="utf-8") as f:
        json.dump(all_results, f, indent=2, ensure_ascii=False)
    write_results_csv(all_results, os.path.join(args.results_dir, "evaluation_results.csv"))

    # the comparison figures (main.py:282-320)
    try:
        visualizer = Visualizer(save_dir=args.results_dir)
        visualizer.plot_comprehensive_comparison(all_results)
        visualizer.plot_model_comparison(all_results)
    except Exception as e:  # matplotlib may be missing; the results stand
        print(f"comparison visualization failed: {e}")
        traceback.print_exc()

    print("\nAll models processed; results in", args.results_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
