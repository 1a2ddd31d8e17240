"""Tiny twins of the cells for CPU tests: the cells' own traffic files at
64 x 64 and tiny towers (the port's test widths), so that the program's
plain CPU path and the reference run in seconds."""

import copy
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY_SD = {
    "name": "tiny-sd", "family": "sd1", "source": "test",
    "unet": {"in_channels": 4, "out_channels": 4, "model_channels": 32, "num_res_blocks": 1,
             "channel_mult": [1, 2], "attention_levels": [0, 1], "transformer_depth": 1,
             "num_heads": 2, "context_dim": 64},
    "vae": {"ch": 16, "ch_mult": [1, 2], "num_res_blocks": 1, "z_channels": 4, "embed_dim": 4,
            "scale_factor": 0.18215},
    "clip": {"vocab_size": 1000, "max_length": 77, "hidden_size": 64, "num_layers": 2,
             "num_heads": 2, "intermediate_size": 128, "bos_token": 49406, "eos_token": 49407},
    "clip_g": None,
    "types": {"unet": "float32", "vae": "float32", "clip": "float32", "tf32": False},
    "reduced": [],
}

TINY_XL = dict(copy.deepcopy(TINY_SD), name="tiny-xl", family="sdxl")
# context 128 = CLIP-L's 64 + CLIP-G's 64; ADM 1568 = G's 32-wide pooled + 6 x 256
TINY_XL["unet"].update(context_dim=128, adm_in_channels=1568)
TINY_XL["clip_g"] = {"vocab_size": 1000, "max_length": 77, "width": 64, "num_layers": 2,
                     "num_heads": 2, "mlp_ratio": 4, "projection_dim": 32}


def tiny_cell(cell_name: str, config: dict, size=(64, 64)):
    from benchmark.harness import cell as cells

    real = cells.load_cell(cell_name, ROOT)
    traffic = copy.deepcopy(real.traffic)
    traffic["size"] = list(size)
    return cells.Cell(name=cell_name, chips=1, config=copy.deepcopy(config), traffic=traffic,
                      limits=dict(real.limits), end_to_end=real.end_to_end, per_layer=[],
                      bench_dir=real.bench_dir)

