"""Command-line driver of the port (counterpart of gpt_sovits_tpu/cli.py):

    python -m gpt_sovits_tpu_torch.cli <subcommand> [options]

  slice       cut long recordings at silences        (tools/slicer2.py)
  separate    UVR5 vocal separation                  (tools/uvr5/)
  denoise     FRCRN or spectral-gate denoiser        (tools/cmd-denoise.py)
  asr         transcribe slices -> .list manifest    (tools/asr/)
  prepare     feature extraction stages 1a/1b/1c     (prepare_datasets/)
  train-s1    AR text->semantic training             (s1_train.py)
  train-s2    SoVITS GAN training                    (s2_train.py)
  train-v3    CFM fine-tune (--lora-rank for LoRA)   (s2_train_v3*.py)
  tts         synthesize from the command line       (inference_cli.py)
  serve       HTTP API                               (api_v2.py)
  webui       control panel over HTTP                (webui.py)
  serve-training  character training REST service    (server/)
  list-models newest trained weights per version     (get_trained_models.py)
  export      pt2 / ONNX artifacts for other runtimes (onnx_export.py, export_torch_script*.py)
  download    fetch pretrained checkpoints and assets (download.py)

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


def cmd_denoise(args):
    from gpt_sovits_tpu_torch.corpus.denoise import denoise
    from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, save_wav

    os.makedirs(args.out_dir, exist_ok=True)
    names = [f for f in os.listdir(args.in_dir) if f.lower().endswith(".wav")]
    for name in names:
        wav, sr = load_wav(os.path.join(args.in_dir, name))
        save_wav(os.path.join(args.out_dir, name), denoise(wav, sr, args.ckpt, device=args.device), sr)
    print(f"denoised {len(names)} files -> {args.out_dir}")


def cmd_separate(args):
    """Vocal separation (the uvr5 webui's, tools/uvr5/webui.py:45)."""
    from gpt_sovits_tpu_torch.corpus.uvr5 import separate_vocals
    from gpt_sovits_tpu_torch.dsp.audio_io import load_wav, save_wav

    os.makedirs(args.vocal_dir, exist_ok=True)
    os.makedirs(args.other_dir, exist_ok=True)
    paths = ([os.path.join(args.in_dir, f) for f in sorted(os.listdir(args.in_dir)) if f.lower().endswith(".wav")]
             if args.in_dir else [args.input])
    for path in paths:
        wav, sr = load_wav(path, mono=False)
        if wav.ndim == 2:
            wav = wav.T  # (L, C) -> (C, L)
        vocals, other = separate_vocals(wav, sr, backend=args.backend, model_path=args.model, config_path=args.config,
                                        agg=args.agg, device=args.device)
        base = os.path.splitext(os.path.basename(path))[0]
        save_wav(os.path.join(args.vocal_dir, f"vocal_{base}.wav"), vocals.T if vocals.ndim == 2 else vocals, sr)
        save_wav(os.path.join(args.other_dir, f"instrument_{base}.wav"), other.T if other.ndim == 2 else other, sr)
    print(f"separated {len(paths)} files -> {args.vocal_dir} / {args.other_dir}")


def cmd_asr(args):
    """Transcribe a directory of slices into the training `.list` manifest
    (tools/asr/; funasr / faster_whisper are optional and imported lazily)."""
    from gpt_sovits_tpu_torch.corpus.asr import transcribe_dir

    out = transcribe_dir(args.in_dir, args.output, language=args.language, speaker=args.speaker)
    print(f"wrote manifest: {out}")


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


def cmd_webui(args):
    """The control panel (reference webui.py, port 9874): data tools, dataset
    preparation, training, label proofreading, as logged background jobs."""
    from gpt_sovits_tpu_torch.serve.webui import serve_webui

    server = serve_webui(host=args.host, port=args.port)
    print(f"webui on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        _forever()
    except KeyboardInterrupt:
        server.shutdown()


def service_config(args):
    """The `serve-training` subcommand's ServiceConfig: the GSVT_* settings,
    then the flags given."""
    from gpt_sovits_tpu_torch.serve.training_steps import ServiceConfig

    cfg = ServiceConfig()
    for name in ("root", "host", "port", "version", "bert_path", "hubert_path", "sv_path", "pretrained_s2g",
                 "pretrained_s2d", "pretrained_s1", "device"):
        v = getattr(args, name, None)
        if v is not None:
            setattr(cfg, name, v)
    return cfg


def cmd_serve_training(args):
    """The character-based training REST service with the production steps
    (reference server/start_service.sh)."""
    from gpt_sovits_tpu_torch.serve.training_steps import main as run_service

    run_service(service_config(args))


def cmd_download(args):
    """Fetch pretrained assets (install.sh's model fetching and the
    reference's on-demand G2PWModel / UVR5 / funasr downloads)."""
    from gpt_sovits_tpu_torch.utils import download as dl

    did = False
    if args.models:
        dl.download_all(args.dest, names=args.names or None)
        did = True
    if args.g2pw:
        print(dl.download_g2pw(args.dest))
        did = True
    if args.uvr5:
        print(dl.download_uvr5(os.path.join(args.dest, "uvr5_weights")))
        did = True
    if args.asr:
        print(dl.download_asr(os.path.join(args.dest, "asr_models"), languages=tuple(args.asr)))
        did = True
    if args.frcrn:
        print(dl.download_frcrn(args.dest))
        did = True
    if not did:
        dl.download_all(args.dest)


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


def cmd_export(args) -> dict:
    """The export artifacts of the given model files, loaded on --device:
    `<name>.pt2` (utils/export.py, a torch.export program) or `<name>.onnx`
    (utils/onnx_export.py), named as the JAX package names them. -> {name:
    {"path", "bytes", "export_s"}}."""
    from gpt_sovits_tpu_torch import resolve_device
    from gpt_sovits_tpu_torch.utils import export as ex
    from gpt_sovits_tpu_torch.utils import loaders

    fmt = args.format
    if fmt == "onnx":
        from gpt_sovits_tpu_torch.utils import onnx_export as oe
    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    out = {}

    def write(name, make):
        t0 = time.perf_counter()
        blob = make()
        path = os.path.join(args.out_dir, f"{name}.{fmt}")
        with open(path, "wb") as f:
            f.write(blob)
        out[name] = {"path": path, "bytes": len(blob), "export_s": time.perf_counter() - t0}

    version = args.version
    if args.s1:
        model = loaders.load_s1(args.s1).to(dev).eval()  # f32, as the JAX package's ONNX artifact
        if fmt == "onnx":
            write("s1_prefill", lambda: oe.export_s1_prefill_onnx(model))
            write("s1_step", lambda: oe.export_s1_step_onnx(model))
        else:
            write("s1_step", lambda: ex.export_s1_step(model))
    if args.s2:
        model, version = loaders.load_s2(args.s2, args.version)
        model = model.to(dev).eval()
        if version in ("v3", "v4"):  # export_torch_script_v3v4 equivalent
            if fmt == "onnx":
                raise SystemExit("ONNX export covers v1/v2 graphs (like the reference's "
                                 "onnx_export.py); use --format pt2 for the v3/v4 CFM path")
            write(f"s2_encp_{version}", lambda: ex.export_v3_decode(model))
            write(f"cfm_{version}", lambda: ex.export_cfm(model, n_steps=args.sample_steps))
        else:
            write(f"s2_decode_{version}", lambda: (oe.export_s2_decode_onnx if fmt == "onnx" else ex.export_s2_decode)(model))
    if args.vocoder:
        model = loaders.load_vocoder(args.vocoder, version or "v3").to(dev).eval()
        write("vocoder", lambda: (oe.export_vocoder_onnx if fmt == "onnx" else ex.export_vocoder)(model))
    print("export done:", args.out_dir)
    return out


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

    s = sub.add_parser("denoise")
    s.add_argument("--in-dir", required=True)
    s.add_argument("--out-dir", required=True)
    s.add_argument("--ckpt", default=None, help="FRCRN pytorch_model.bin (default: $GSVT_FRCRN_CKPT, else spectral gate)")
    _device(s)
    s.set_defaults(fn=cmd_denoise)

    s = sub.add_parser("separate", help="UVR5 vocal separation (roformer/vr/mdx/hpss)")
    g = s.add_mutually_exclusive_group(required=True)
    g.add_argument("--input")
    g.add_argument("--in-dir")
    s.add_argument("--vocal-dir", required=True)
    s.add_argument("--other-dir", required=True)
    s.add_argument("--model", help="UVR5 weight file (.ckpt/.pth/.onnx); omit for HPSS fallback")
    s.add_argument("--config", help="roformer YAML (optional)")
    s.add_argument("--backend", default="auto", choices=["auto", "roformer", "vr", "mdx", "hpss"])
    s.add_argument("--agg", type=int, default=10, help="VR aggressiveness 0-100")
    _device(s)
    s.set_defaults(fn=cmd_separate)

    s = sub.add_parser("asr", help="transcribe slices into the training .list manifest (tools/asr)")
    s.add_argument("--in-dir", required=True)
    s.add_argument("--output", required=True, help="path of the .list manifest to write")
    s.add_argument("--language", default="zh")
    s.add_argument("--speaker", default="speaker")
    s.set_defaults(fn=cmd_asr)

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

    s = sub.add_parser("export")
    s.add_argument("--out-dir", required=True)
    s.add_argument("--s1")
    s.add_argument("--s2")
    s.add_argument("--version")
    s.add_argument("--vocoder", help="v3 BigVGAN / v4 generator checkpoint to export")
    s.add_argument("--sample-steps", type=int, default=8, help="Euler steps baked into the exported CFM program")
    s.add_argument("--format", choices=("pt2", "onnx"), default="pt2",
                   help="pt2: a torch.export program (torch.export.load); onnx: standard .onnx graphs "
                        "(v1/v2 + vocoder)")
    _device(s)
    s.set_defaults(fn=cmd_export)

    s = sub.add_parser("webui", help="master control panel (webui.py equivalent)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=9874)
    s.set_defaults(fn=cmd_webui)

    s = sub.add_parser("serve-training", help="character-based training REST service (server/)")
    s.add_argument("--root", help="character data root (default: GSVT_SERVICE_ROOT or ./characters)")
    s.add_argument("--host")
    s.add_argument("--port", type=int)
    s.add_argument("--version")
    s.add_argument("--bert-path")
    s.add_argument("--hubert-path")
    s.add_argument("--sv-path")
    s.add_argument("--pretrained-s2g")
    s.add_argument("--pretrained-s2d")
    s.add_argument("--pretrained-s1")
    _device(s)
    s.set_defaults(fn=cmd_serve_training)

    s = sub.add_parser("download", help="fetch pretrained checkpoints / G2PWModel / UVR5 / ASR assets")
    s.add_argument("--dest", default="pretrained_models")
    s.add_argument("--models", action="store_true", help="core checkpoints (default when no flag given)")
    s.add_argument("--names", nargs="*", help="subset of asset names (see utils/download.PRETRAINED)")
    s.add_argument("--g2pw", action="store_true", help="G2PWModel bundle for zh polyphone g2p")
    s.add_argument("--uvr5", action="store_true", help="UVR5 separation weights bundle")
    s.add_argument("--asr", nargs="*", metavar="LANG", help="prefetch funasr models (e.g. --asr zh)")
    s.add_argument("--frcrn", action="store_true", help="FRCRN denoiser checkpoint (cli denoise --ckpt)")
    s.set_defaults(fn=cmd_download)

    s = sub.add_parser("list-models", help="newest trained GPT/SoVITS weights per version (get_trained_models.py)")
    s.add_argument("--root", default=".", help="directory holding GPT_weights*/SoVITS_weights* dirs")
    s.set_defaults(fn=cmd_list_models)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
