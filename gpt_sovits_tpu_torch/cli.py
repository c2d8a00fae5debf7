"""Command-line driver of the port (counterpart of gpt_sovits_tpu/cli.py):

    python -m gpt_sovits_tpu_torch.cli <subcommand> [options]

  slice       cut long recordings at silences        (tools/slicer2.py)
  prepare     feature extraction stages 1a/1b/1c     (prepare_datasets/)
  train-s1    AR text->semantic training             (s1_train.py)
  train-s2    SoVITS GAN training                    (s2_train.py)
  train-v3    CFM fine-tune (--lora-rank for LoRA)   (s2_train_v3*.py)
  tts         synthesize from the command line       (inference_cli.py)
  serve       HTTP API                               (api_v2.py)
  list-models newest trained weights per version     (get_trained_models.py)

The subcommands that compute run on the CUDA card unless `--device cpu`
is given. The model files are the reference project's (utils/loaders.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np


def cmd_slice(args):
    from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, save_wav
    from gpt_sovits_tpu_torch.dsp.slicer import Slicer

    os.makedirs(args.out_dir, exist_ok=True)
    wav, sr = load_wav(args.input)
    slicer = Slicer(sr, threshold=args.threshold, min_length=args.min_length,
                    min_interval=args.min_interval, hop_size=args.hop_size,
                    max_sil_kept=args.max_sil_kept)
    base = os.path.splitext(os.path.basename(args.input))[0]
    for i, chunk in enumerate(slicer.slice(wav)):
        save_wav(os.path.join(args.out_dir, f"{base}_{i:04d}.wav"), chunk, sr)
    print(f"wrote {i + 1} slices to {args.out_dir}")


def cmd_prepare(args):
    from gpt_sovits_tpu_torch.run import run_prepare

    run_prepare(args.list, args.exp_dir, version=args.version, bert=args.bert, hubert=args.hubert, s2=args.s2,
                sv=args.sv, device=args.device)


def cmd_train_s1(args):
    from gpt_sovits_tpu_torch.run import run_train_s1

    run_train_s1(args.exp_dir, args.ckpt_dir, batch_size=args.batch_size, epochs=args.epochs,
                 save_every=args.save_every, dpo=args.dpo, pretrained_s1=args.pretrained_s1,
                 data_parallel=args.dp, device=args.device)


def cmd_train_s2(args):
    from gpt_sovits_tpu_torch.run import run_train_s2

    try:
        run_train_s2(args.exp_dir, args.ckpt_dir, version=args.version, batch_size=args.batch_size,
                     epochs=args.epochs, save_every=args.save_every, pretrained_s2g=args.pretrained_s2g,
                     pretrained_s2d=args.pretrained_s2d, data_parallel=args.dp, device=args.device)
    except RuntimeError as e:
        sys.exit(str(e))


def cmd_train_v3(args):
    from gpt_sovits_tpu_torch.run import run_train_v3

    try:
        run_train_v3(args.exp_dir, args.ckpt_dir, version=args.version, batch_size=args.batch_size,
                     epochs=args.epochs, save_every=args.save_every, lora_rank=args.lora_rank,
                     pretrained=args.pretrained, data_parallel=args.dp, device=args.device)
    except RuntimeError as e:
        sys.exit(str(e))


def _pipeline(args, **kw):
    from gpt_sovits_tpu_torch.utils.loaders import build_pipeline

    return build_pipeline(s1_path=args.s1, s2_path=args.s2, version=args.version, hubert_path=args.hubert,
                          bert_path=args.bert, sv_path=args.sv, device=args.device, **kw)


def cmd_tts(args) -> dict:
    """Writes the WAV; -> {"pipeline", "sr", "audio", "wall_s"} for a caller
    in the same process."""
    from gpt_sovits_tpu_torch.dsp.audio_io import save_wav

    pipe = _pipeline(args)
    pipe.set_ref_audio(args.ref_audio, ref_text=args.ref_text, ref_lang=args.ref_lang)
    t0 = time.perf_counter()
    sr, audio = pipe.run(args.text, args.lang, seed=args.seed, cut_method=args.cut)
    wall = time.perf_counter() - t0
    save_wav(args.output, audio.astype(np.float32) / 32768.0, sr)
    print(f"wrote {args.output} ({len(audio) / sr:.2f}s @ {sr} Hz)")
    return {"pipeline": pipe, "sr": sr, "audio": audio, "wall_s": wall}


def make_service(args):
    """The `serve` subcommand's TTSService (and its continuous service with
    --continuous), built without serving: tests and chip_smoke.py call it.
    As in the JAX package, no weight loader is given."""
    from gpt_sovits_tpu_torch.serve.api import TTSService

    pipe = _pipeline(args, s1_weight_quant=args.s1_quant, s1_kv_quant=args.kv_quant)
    continuous = None
    if args.continuous:
        from gpt_sovits_tpu_torch.serve.continuous_service import ContinuousTTSService

        continuous = ContinuousTTSService(pipe, slots=args.slots)
    return TTSService(pipe, continuous=continuous)


def _forever() -> None:
    threading.Event().wait()


def cmd_serve(args):
    from gpt_sovits_tpu_torch.serve.api import serve

    service = make_service(args)
    server = serve(service, host=args.host, port=args.port)  # serves on its own thread
    print(f"serving on {args.host}:{server.server_address[1]}", flush=True)
    try:
        _forever()
    except KeyboardInterrupt:
        server.shutdown()
        if service.continuous is not None:
            service.continuous.close()


def cmd_list_models(args):
    """Trained weights per version directory as JSON (get_trained_models.py)."""
    import json

    from gpt_sovits_tpu_torch.run import latest_step_model

    out = {}
    for version in ("v1", "v2", "v2Pro", "v2ProPlus", "v3", "v4"):
        suffix = "" if version == "v1" else f"_{version}"
        gpt = latest_step_model(os.path.join(args.root, f"GPT_weights{suffix}"), ".ckpt")
        sovits = latest_step_model(os.path.join(args.root, f"SoVITS_weights{suffix}"), ".pth")
        if gpt or sovits:
            out[version] = {"gpt": gpt, "sovits": sovits}
    print(json.dumps(out, indent=2))


def _device(s):
    s.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' for the CPU)")


def _models(s):
    for flag in ("--s1", "--s2", "--version", "--hubert", "--bert", "--sv"):
        s.add_argument(flag)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gpt_sovits_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("slice")
    s.add_argument("input")
    s.add_argument("--out-dir", required=True)
    s.add_argument("--threshold", type=float, default=-34.0)
    s.add_argument("--min-length", type=int, default=4000)
    s.add_argument("--min-interval", type=int, default=300)
    s.add_argument("--hop-size", type=int, default=10)
    s.add_argument("--max-sil-kept", type=int, default=500)
    s.set_defaults(fn=cmd_slice)

    s = sub.add_parser("prepare")
    s.add_argument("--list", required=True)
    s.add_argument("--exp-dir", required=True)
    s.add_argument("--version", default="v2")
    s.add_argument("--bert")
    s.add_argument("--hubert")
    s.add_argument("--s2")
    s.add_argument("--sv")
    _device(s)
    s.set_defaults(fn=cmd_prepare)

    dp_help = "data-parallel over the process group that parallel/launch.init joined (replaces DDP)"
    s = sub.add_parser("train-s1")
    s.add_argument("--exp-dir", required=True)
    s.add_argument("--ckpt-dir", required=True)
    s.add_argument("--batch-size", type=int, default=8)
    s.add_argument("--epochs", type=int, default=15)
    s.add_argument("--save-every", type=int, default=5)
    s.add_argument("--dpo", action="store_true")
    s.add_argument("--pretrained-s1", help="reference s1*.ckpt to fine-tune from")
    s.add_argument("--dp", action="store_true", help=dp_help)
    _device(s)
    s.set_defaults(fn=cmd_train_s1)

    s = sub.add_parser("train-s2")
    s.add_argument("--exp-dir", required=True)
    s.add_argument("--ckpt-dir", required=True)
    s.add_argument("--version", default="v2")
    s.add_argument("--batch-size", type=int, default=8)
    s.add_argument("--epochs", type=int, default=8)
    s.add_argument("--save-every", type=int, default=4)
    s.add_argument("--pretrained-s2g", help="reference s2G*.pth to fine-tune from")
    s.add_argument("--pretrained-s2d", help="reference s2D*.pth discriminator warm start")
    s.add_argument("--dp", action="store_true", help=dp_help)
    _device(s)
    s.set_defaults(fn=cmd_train_s2)

    s = sub.add_parser("train-v3", help="v3/v4 CFM fine-tune (s2_train_v3.py; --lora-rank for LoRA)")
    s.add_argument("--exp-dir", required=True)
    s.add_argument("--ckpt-dir", required=True)
    s.add_argument("--version", default="v3", choices=["v3", "v4"])
    s.add_argument("--batch-size", type=int, default=4)
    s.add_argument("--epochs", type=int, default=4)
    s.add_argument("--save-every", type=int, default=2)
    s.add_argument("--lora-rank", type=int, default=0, help=">0: train LoRA deltas only (s2_train_v3_lora.py)")
    s.add_argument("--pretrained", help="reference v3/v4 SoVITS .pth to fine-tune from")
    s.add_argument("--dp", action="store_true", help=dp_help)
    _device(s)
    s.set_defaults(fn=cmd_train_v3)

    s = sub.add_parser("tts")
    s.add_argument("--text", required=True)
    s.add_argument("--lang", default="auto")
    s.add_argument("--ref-audio", required=True)
    s.add_argument("--ref-text")
    s.add_argument("--ref-lang", default="auto", help="prompt transcript language mode")
    s.add_argument("--output", default="output.wav")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--cut", default="cut5")
    _models(s)
    _device(s)
    s.set_defaults(fn=cmd_tts)

    s = sub.add_parser("serve")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=9880)
    _models(s)
    s.add_argument("--continuous", action="store_true",
                   help="continuous batching: concurrent /tts requests share the S1 slot pool")
    s.add_argument("--slots", type=int, default=8, help="continuous-mode slot count")
    s.add_argument("--s1-quant", choices=("bf16", "int8"), default=None,
                   help="S1 decode weight quantization (default: int8 on a card)")
    s.add_argument("--kv-quant", choices=("bf16", "int8"), default=None,
                   help="S1 KV-cache quantization (default: int8 on a card)")
    _device(s)
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("list-models", help="newest trained GPT/SoVITS weights per version (get_trained_models.py)")
    s.add_argument("--root", default=".", help="directory holding GPT_weights*/SoVITS_weights* dirs")
    s.set_defaults(fn=cmd_list_models)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
