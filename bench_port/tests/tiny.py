"""Small configurations and mixes of the benchmark's cells, for rehearsals
on the CPU: the published configuration files with their widths and depths
cut down (the sample rates, hops, mel channels, vocabularies and the S1
layout kept), and the mixes with short caps."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from bench_port import run as bench_run

ROOT = Path(__file__).resolve().parents[2]

HUBERT = {"conv_dim": 32, "hidden_size": 64, "num_layers": 2, "num_heads": 2, "intermediate_size": 128,
          "pos_conv_kernel": 16, "pos_conv_groups": 4}
S1 = {"embedding_dim": 64, "hidden_dim": 64, "num_heads": 4, "ffn_dim": 128, "num_layers": 2}
S2 = {"inter_channels": 16, "hidden_channels": 32, "filter_channels": 64, "n_layers": 2, "gin_channels": 32,
      "mrte_hidden": 32, "ssl_dim": 64}


def config(name: str) -> dict:
    cfg = json.loads((ROOT / "bench_port" / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["hubert"].update(HUBERT)
    cfg["s1"].update(S1)
    cfg["s2"].update(S2)
    if cfg["family"] == "vits":
        cfg["s2"].update(upsample_initial_channel=32, sv_dim=1280)
        cfg["sv"].update(num_blocks=[1, 1, 1, 1], m_channels=8, base_width=8, scale=2, expansion=2)
        cfg["serving"].update(max_new=40, tx_max=64, tp_max=192)
    else:
        cfg["s2"].update(cfm_dit_dim=128, cfm_dit_depth=2, cfm_dit_heads=2)
        cfg["vocoder"].update(upsample_initial_channel=32)
        cfg["cfm"].update(sample_steps=4)
    return cfg


def cell(name: str, *, clients: int | None = None, shapes: list | None = None) -> bench_run.Cell:
    """The cell of BENCHMARK.json with its configuration cut down and its mix
    shortened."""
    c = bench_run.Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), name)
    c.cfg = config(c.entry["config"])
    c.mix = copy.deepcopy(c.mix)
    if clients is not None:
        c.mix["clients"] = clients
    if shapes is not None:
        c.mix["shapes"] = {"values": shapes, "counts": [1] * len(shapes)}
    return c
