"""Copies of the port with one fault planted in a CUDA kernel (K1's whole
step in `csrc/decode_step.cu`, K6 `csrc/snake_aa.cu` and its plan in
`ops/snake_aa.py`, K3, K4's path and the s8 GEMM of K2/K3/K4 in
`csrc/qmatmul.cu` and its plan in `ops/qmatmul.py`, K5 `csrc/qflash.cu`),
in the continuous-batching pool that drives K1 (`infer/continuous.py`), in
the pipeline's zh BERT features (`infer/pipeline.py`), in the corpus tools
(the RoFormer's rotary in `corpus/roformer.py`, FRCRN's masks in
`models/frcrn.py`), in the training BigVGAN's activations (`models/bigvgan.py` with K6's gradient refusal
removed), in the reference-checkpoint loaders (`utils/loaders.py`), in
the reference-format export (`train/ckpt.py`) or in the export path (the
functional S1 step of `models/t2s.py`, the ONNX converter of
`utils/onnx_export.py`), each of which must fail chip_smoke.py's check of
that kernel or path on the card.

    python3 broken_copies.py        # one CUDA card; exits non-zero if a copy passes its check

Each copy is gpt_sovits_tpu_torch/ and chip_smoke.py under a temporary
directory outside the checkout, with one line of one source replaced (or,
where a fault needs it, one line in each of several sources); its checks
(chip_smoke.k1_case, k1_rows_case, snake_case, k3_case, k4_case, k5_case
or gemm_case at a main-path shape, k1_sweep_case, serve_case,
path_zh_case, train_bigvgan_case, cli_case, roformer_case, frcrn_case,
export_case) run
in a child process there, which builds the copy's kernels. The same checks run first on the unbroken
sources and must pass. One JSON line per copy and check: the check's
outcome and the end of its assertion message.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DS = "gpt_sovits_tpu_torch/csrc/decode_step.cu"
SNAKE = "gpt_sovits_tpu_torch/csrc/snake_aa.cu"
SNAKE_PY = "gpt_sovits_tpu_torch/ops/snake_aa.py"
QMM = "gpt_sovits_tpu_torch/csrc/qmatmul.cu"
QMM_PY = "gpt_sovits_tpu_torch/ops/qmatmul.py"
QFLASH = "gpt_sovits_tpu_torch/csrc/qflash.cu"
DS_PY = "gpt_sovits_tpu_torch/ops/decode_step.py"
POOL = "gpt_sovits_tpu_torch/infer/continuous.py"
PIPE = "gpt_sovits_tpu_torch/infer/pipeline.py"
BIGVGAN = "gpt_sovits_tpu_torch/models/bigvgan.py"
LOADERS = "gpt_sovits_tpu_torch/utils/loaders.py"
ROFORMER = "gpt_sovits_tpu_torch/corpus/roformer.py"
FRCRN = "gpt_sovits_tpu_torch/models/frcrn.py"
CKPT = "gpt_sovits_tpu_torch/train/ckpt.py"
T2S = "gpt_sovits_tpu_torch/models/t2s.py"
ONNX_EXPORT = "gpt_sovits_tpu_torch/utils/onnx_export.py"
CHECKS = {
    # K1's whole step at full width, random and peaked inputs (step_cases)
    "k1_int8": "c.k1_case('int8', 1, g)",
    "k1_bf16": "c.k1_case('bf16', 4, g)",
    # K1's whole step with one write slot a row, random and peaked inputs (rowwise_cases)
    "k1_rows_int8": "c.k1_rows_case('int8', 2, g)",
    "k1_rows_bf16": "c.k1_rows_case('bf16', 4, g)",
    # K3 at the DiT chunk (T 1024) with a q scale
    "k3_b1": "c.k3_case(1, 1024, 0.125, g)",
    # K6 at the first stage shape (1112 chunks of 8: 4 whole tiles of 240 and a partial one)
    "snake_f32": "c.snake_case(768, 8896, torch.float32, g, timed=False)",
    "snake_bf16": "c.snake_case(768, 8896, torch.bfloat16, g, timed=False)",
    # K6 where rows start off a 16-byte boundary (T % 8 != 0): the scalar head and tail
    "snake_ragged_f32": "c.snake_case(768, 8897, torch.float32, g, timed=False)",
    "snake_ragged_bf16": "c.snake_case(768, 8897, torch.bfloat16, g, timed=False)",
    "k4": "c.k4_case(1, g)",
    # K5 at the DiT chunk (T 1024, 1000 real keys), B = 1 and 4, and at a T
    # whose last 128-key tile is partial
    "k5_b1": "c.k5_case(1, 1024, 1000, g)",
    "k5_b4": "c.k5_case(4, 1024, 1000, g)",
    "k5_t1000": "c.k5_case(1, 1000, 960, g)",
    # K2's block at M = 1000: the GEMM's last 128-row block is ragged
    "gemm_ragged": "c.gemm_case(1, 1000, g)",
    # K1 at B=8, one write slot a row, under the serving pool's split plan (sweep_cases)
    "k1_sweep_int8": "c.k1_sweep_case('int8', g)",
    # the continuous-batching pool on K1 at full width: serve_v2 (pool layout and the pool's
    # own step against the twin, waves, greedy bar)
    "serve": "c.serve_case(g)",
    # the zh requests through the v2ProPlus pipeline with BERT at full width: path_zh (every g2p call's
    # BERT rows non-zero exactly on its zh phones, each seen by S1's bert_proj)
    "path_zh": "c.path_zh_case(g)",
    # BigVGAN GAN training at full width on the plain snake composition: train_bigvgan (K1-K7
    # launched 0 times, every gradient card vs CPU)
    "train_bigvgan": "c.train_bigvgan_case(g)",
    # the loaders on reference-format files from the seed: cli (every loaded tensor equals the file's weights
    # after the container's fp16 rounding; weight-norm pairs folded as torch folds them)
    "cli": "c.cli_case(g)",
    # the corpus tools at full width: the BS-RoFormer's first time and band attentions against the
    # complex-number rotary formulation; FRCRN's output against its masks composed from its two U-Nets
    "roformer_rotary": "c.roformer_case(g)",
    "frcrn_masks": "c.frcrn_case(g)",
    # the exporters on seeded full-width models: the S1 step as pt2 and ONNX (its returned caches hold the fresh
    # K/V at the slot) and the v2ProPlus S2 decode as ONNX, each against the eager module on the card
    "export": "c.export_case(g)",
}
# (name, source, the line as it is, the broken line, checks that must fail); a fault
# that needs lines in several sources gives a tuple of each

COPIES = [
    ("K1: the grid barrier after the attention phase skipped", DS, "        grid_sync(a.sync, base + ++n_bar * GRID);  // ctx written",
     "        // barrier skipped", ("k1_int8", "k1_bf16")),
    ("K1: mask ignored", DS, "            if (!(mk[r] > 0.f)) sc[r] = NEG;", "            // mask ignored",
     ("k1_int8", "k1_bf16")),
    ("K1: the fresh K/V dropped", DS, "    const float w_self = expf(sc_self - m_all);  // the fresh K/V's weight",
     "    const float w_self = 0.f;", ("k1_int8", "k1_bf16")),
    ("K1: the last layer skipped", DS, "    for (int l = 0; l < a.L; ++l) {", "    for (int l = 0; l < a.L - 1; ++l) {",
     ("k1_int8", "k1_bf16")),
    ("K1: every row's new K/V written at row 0's slot", DS, "    const int slot = a.slot[b];",
     "    const int slot = a.slot[0];", ("k1_rows_int8", "k1_rows_bf16")),
    ("K3: rotary on no head", QMM, "        if (rotate && col < dh) {", "        if (false) {", ("k3_b1",)),
    ("K3: rotary on every head", QMM, "        if (rotate && col < dh) {", "        if (rotate) {", ("k3_b1",)),
    ("K3: the rotary table read one position off", QMM, "            const size_t rt = (size_t)tt * half + col / 2;",
     "            const size_t rt = (size_t)(tt + 1) * half + col / 2;", ("k3_b1",)),
    ("K3: q_scale dropped", QMM, "        if (z == 0 && q_scale != 1.0f) {", "        if (false) {", ("k3_b1",)),
    ("K3: v projected with k's weights", QMM,
     "    const CUtensorMap* tm_w = z == 0 ? &tm_wq : z == 1 ? &tm_wk : &tm_wv;",
     "    const CUtensorMap* tm_w = z == 0 ? &tm_wq : &tm_wk;", ("k3_b1",)),
    ("K6: s's index not clamped (the interior formula carried on through x at the edges)", SNAKE,
     "    const bool first = EDGE && c <= 0 && c + R > 0, last = EDGE && c <= n - 1 && c + R > n - 1;",
     "    const bool first = false, last = false;", ("snake_f32", "snake_bf16")),
    ("K6: the next channel's alpha and beta", SNAKE, "    const int ch = row % C;",
     "    const int ch = (row + 1) % C;", ("snake_f32", "snake_bf16")),
    ("K6: the last, partial time tile dropped", SNAKE_PY, "    tiles = -(-chunks // per_tile)",
     "    tiles = chunks // per_tile", ("snake_f32", "snake_bf16")),
    ("K6: the shuffle halo taken from the wrong lane (offset off by one)", SNAKE,
     "            xa[i] = __shfl_up_sync(FULL, xv[R - 3 + i], 1);",
     "            xa[i] = __shfl_up_sync(FULL, xv[R - 3 + i], 2);", ("snake_f32", "snake_bf16")),
    ("K6: the scalar head of a misaligned row skipped", SNAKE,
     "    const int h0 = head > 0 ? head - R : 0;                 // chunk 0 ends at that boundary",
     "    const int h0 = head;", ("snake_ragged_f32", "snake_ragged_bf16")),
    ("K6: a warp's edge samples taken from the wrong neighbour", SNAKE,
     "    const int j = (tile * WARPS + warp) * 30 + lane - 1;",
     "    const int j = (tile * WARPS + warp) * 30 + (lane == 0 ? 30 : lane - 1);", ("snake_f32", "snake_bf16")),
    ("K4: heads merged in reverse order", QMM,
     "                src = x + ((b * H + k0 / dh) * T + t) * dh + k0 % dh;",
     "                src = x + ((b * H + (H - 1 - k0 / dh)) * T + t) * dh + k0 % dh;", ("k4",)),
    ("K4: heads-in layout read as merged", QMM, "            if (HEADS) {  // head k0 / dh of row (b, t): x[b, k0 / dh, t, k0 % dh]",
     "            if (false) {", ("k4",)),
    ("K4: pad-row mask ignored (the GEMM's epilogue)", QMM,
     "        const bool keep = mask == nullptr || mask[row] > 0.f;", "        const bool keep = true;", ("k4",)),
    ("GEMM: the last K slot dropped", QMM, "    const int nk = (K + C::BK - 1) / C::BK;",
     "    const int nk = (K + C::BK - 1) / C::BK - 1;", ("k4", "gemm_ragged", "k3_b1")),
    ("GEMM: a ragged M's last row block dropped", QMM_PY, "    grid_m = -(-m // GEMM_TILE_M)",
     "    grid_m = m // GEMM_TILE_M", ("gemm_ragged",)),
    ("K5: mask ignored", QFLASH, "    return (maskb == nullptr || maskb[key] > 0.f) ? 0.f : -1e9f;",
     "    return 0.f;", ("k5_b1", "k5_b4")),
    ("K5: the last, partial key tile dropped", QFLASH, "    const int n_tiles = (T + KB - 1) / KB;",
     "    const int n_tiles = T / KB;", ("k5_t1000",)),
    ("K5: ring slot k+1's tile consumed as slot k's", QFLASH, "        const uint8_t* k_tile = sk + st * K_BYTES;",
     "        const uint8_t* k_tile = sk + ((st + 1) % FA_STAGES) * K_BYTES;", ("k5_b1",)),
    ("pool: a row installed one slot off", POOL, "        s.kv[:, sl] = kv.to(s.kv.dtype)",
     "        s.kv[:, sl, 1:] = kv[:, :, :-1].to(s.kv.dtype)", ("serve",)),
    ("pool: every row stepped at row 0's write slot", POOL,
     "        slots = self.scratch + np.maximum(g - 1, 0)  # (n, B): the token sampled g - 1 steps ago",
     "        slots = np.repeat(self.scratch + np.maximum(g[:, :1] - 1, 0), b, axis=1)", ("serve",)),
    ("K1: rows 4-7 write at the slots of rows 0-3", DS, "    const int slot = a.slot[b];",
     "    const int slot = a.slot[b & 3];", ("k1_sweep_int8", "serve")),
    ("K1 plan: slot_r for the step's own sweep, the split count for the plan's", DS_PY,
     "    return slot_r, max(1, -(-n_valid // (32 * slot_r)))",
     "    return step_splits(n_valid, kv_int8)[0], max(1, -(-n_valid // (32 * slot_r)))", ("k1_sweep_int8",)),
    ("pipeline: zh runs' BERT features replaced by zeros", PIPE,
     '        if lang == "zh" and self.bert is not None and word2ph is not None:', "        if False:", ("path_zh",)),
    ("training BigVGAN: its activations through K6, the gradient refusal removed", (BIGVGAN, SNAKE_PY),
     ("        fn = snake_aa if self.use_kernel else snake_aa_plain", '    refuse_grad("snake_aa", x, alpha, beta)'),
     ("        fn = snake_aa", "    pass"), ("train_bigvgan",)),
    ("loaders: HuBERT's pos_conv folded over dim 0 (HF's weight_norm is over dim 2)", LOADERS,
     "    model.load_state_dict(_floats(fold_weight_norm(sd, dim=2)))",
     "    model.load_state_dict(_floats(fold_weight_norm(sd, dim=0)))", ("cli",)),
    ("exports: the reference container's fp16 rounding skipped (the files hold float32)", CKPT,
     '    opt = {"weight": {k: v.detach().cpu().half() for k, v in state_dict.items()}, "config": config or {},',
     '    opt = {"weight": {k: v.detach().cpu() for k, v in state_dict.items()}, "config": config or {},', ("cli",)),
    ("RoFormer: the rotary's pairs taken as halves, not interleaved", ROFORMER,
     "    return torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).reshape(x.shape)",
     "    return torch.cat((-x[..., x.shape[-1] // 2:], x[..., : x.shape[-1] // 2]), dim=-1)", ("roformer_rotary",)),
    ("FRCRN: the second mask without its tanh", FRCRN, "        m2 = torch.tanh(self.unet2(u1)) + m1",
     "        m2 = self.unet2(u1) + m1", ("frcrn_masks",)),
    ("exported S1 step: the input caches returned unwritten", T2S,
     "        return self.ar_predict_layer(x[:, 0]), torch.stack(new_ks), torch.stack(new_vs)",
     "        return self.ar_predict_layer(x[:, 0]), k_caches, v_caches", ("export",)),
    ("ONNX: the transposed convolution's kernel flipped in time (the JAX lowering's flip carried over)", ONNX_EXPORT,
     "    w = ins[1]  # torch's (in, out/g, k) kernel is ConvTranspose's as it is: no flip",
     "    w = cv.flip(ins[1], range(2, 2 + spatial), _meta(node.args[1]).shape)", ("export",)),
]


def edits(copy) -> list[tuple[str, str, str]]:
    """A copy's (source, line as it is, broken line) edits."""
    _, src, old, new, _ = copy
    return list(zip(src, old, new)) if isinstance(src, tuple) else [(src, old, new)]


def run_check(tree: Path, check: str) -> tuple[bool, str]:
    code = f"import torch, chip_smoke as c\nc.resolve_device('cuda')\ng = torch.Generator('cuda').manual_seed(0)\n{CHECKS[check]}\n"
    res = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True, timeout=900)
    tail = (res.stderr.strip().splitlines() or [""])[-1]
    return res.returncode == 0, tail[-400:]


def copy_tree(dst: Path) -> Path:
    shutil.copytree(ROOT / "gpt_sovits_tpu_torch", dst / "gpt_sovits_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    return dst


def main() -> int:
    ok = True
    with tempfile.TemporaryDirectory(prefix="gsv_broken_") as tmp:
        control = copy_tree(Path(tmp) / "control")
        for check in CHECKS:
            passed, tail = run_check(control, check)
            print(json.dumps({"copy": "unbroken", "check": check, "passed": passed, "message": tail}), flush=True)
            ok &= passed
        for i, copy in enumerate(COPIES):
            name, checks = copy[0], copy[4]
            tree = copy_tree(Path(tmp) / f"copy{i}")
            for src, old, new in edits(copy):
                path = tree / src
                text = path.read_text()
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: the line to break is not in {src} exactly once")
                path.write_text(text.replace(old, new))
            for check in checks:
                passed, tail = run_check(tree, check)
                print(json.dumps({"copy": name, "check": check, "failed": not passed, "message": tail}), flush=True)
                ok &= not passed
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
