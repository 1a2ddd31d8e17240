"""CodeFormer: codebook-lookup transformer face restoration.

Counterpart of stable_renderer_tpu/models/codeformer.py (reference chainner
face/codeformer.py: VectorQuantizer :17-95, the VQ encoder and generator
:137-330, TransformerSALayer :492-533, Fuse_sft_block :578-602, CodeFormer
:604-790). Functional PyTorch over NHWC; the torch Sequential block indices
come from the same structural plans.

Flow: the VQGAN encoder -> a 9-layer transformer predicts codebook indices
(an argmax) -> the quantized features -> the VQGAN generator, with the
``weight`` fidelity knob fusing encoder features by SFT at the connect
resolutions. Its GroupNorms go through ``layers.group_norm`` (K4 under the
GroupNorm switch at C % 128 == 0) and its 3x3 convs through
``layers.conv2d`` (K3 under ``use_pallas_conv(True)`` with bf16
activations where the gate admits them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from stable_renderer_tpu_torch.models.layers import (
    conv2d,
    group_norm,
    layer_norm,
    linear,
    upsample_nearest_2x,
)
from stable_renderer_tpu_torch.models.swinir import Draws


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    return group_norm(p, x, num_groups=32, eps=1e-6)


@dataclass(frozen=True)
class CodeFormerConfig:
    img_size: int = 512
    nf: int = 64
    ch_mult: Tuple[int, ...] = (1, 2, 2, 4, 4, 8)
    res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    codebook_size: int = 1024
    emb_dim: int = 256
    dim_embd: int = 512
    n_head: int = 8
    n_layers: int = 9
    connect_list: Tuple[str, ...] = ("32", "64", "128", "256")

    @property
    def latent_res(self) -> int:
        return self.img_size // 2 ** (len(self.ch_mult) - 1)


TINY_CODEFORMER_CONFIG = CodeFormerConfig(
    img_size=16, nf=8, ch_mult=(1, 2), res_blocks=1, attn_resolutions=(8,),
    codebook_size=32, emb_dim=16, dim_embd=16, n_head=2, n_layers=2, connect_list=("16",))


def _res_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The VQGAN ResBlock (codeformer.py:546-575)."""
    h = conv2d(p["conv1"], _swish(_norm(p["norm1"], x)), padding=1)
    h = conv2d(p["conv2"], _swish(_norm(p["norm2"], h)), padding=1)
    if "conv_out" in p:
        x = conv2d(p["conv_out"], x)
    return x + h


def _attn_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Single-head spatial attention (codeformer.py:165-208)."""
    b, h, w, c = x.shape
    n = _norm(p["norm"], x)
    q, k, v = (conv2d(p[name], n).reshape(b, h * w, c) for name in ("q", "k", "v"))
    attn = torch.softmax(torch.einsum("bnc,bmc->bnm", q, k) * (c ** -0.5), dim=-1)
    out = torch.einsum("bnm,bmc->bnc", attn, v).reshape(b, h, w, c)
    return x + conv2d(p["proj_out"], out)


def _encoder_plan(cfg: CodeFormerConfig):
    """The ordered block plan of the torch Sequential (codeformer.py:211-262)
    and the fuse position at each resolution (its last ResBlock before any
    attention; CodeFormer.fuse_encoder_block)."""
    plan: List[Tuple[str, ...]] = [("conv_in",)]
    fuse: Dict[int, int] = {}
    curr = cfg.img_size
    for i in range(len(cfg.ch_mult)):
        for _ in range(cfg.res_blocks):
            plan.append(("res",))
            fuse[curr] = len(plan) - 1
            if curr in cfg.attn_resolutions:
                plan.append(("attn",))
                fuse[curr] = len(plan) - 2
        if i != len(cfg.ch_mult) - 1:
            plan.append(("down",))
            curr //= 2
    plan += [("res",), ("attn",), ("res",), ("norm",), ("conv_out",)]
    return plan, fuse


def _generator_plan(cfg: CodeFormerConfig):
    """(codeformer.py:269-317) and the fuse positions: the first ResBlock of
    each stage, or the last one in attention stages (fuse_generator_block)."""
    plan: List[Tuple[str, ...]] = [("conv_in",), ("res",), ("attn",), ("res",)]
    fuse: Dict[int, int] = {}
    curr = cfg.latent_res
    for i in reversed(range(len(cfg.ch_mult))):
        first_res_idx = last_res_idx = None
        for _ in range(cfg.res_blocks):
            plan.append(("res",))
            last_res_idx = len(plan) - 1
            if first_res_idx is None:
                first_res_idx = last_res_idx
            if curr in cfg.attn_resolutions:
                plan.append(("attn",))
        fuse[curr] = last_res_idx if curr in cfg.attn_resolutions else first_res_idx
        if i != 0:
            plan.append(("up",))
            curr *= 2
    plan += [("norm",), ("conv_out",)]
    return plan, fuse


def _fuse_sft(p: dict, enc_feat: torch.Tensor, dec_feat: torch.Tensor, w: float) -> torch.Tensor:
    """Fuse_sft_block (codeformer.py:578-602)."""
    h = _res_block(p["encode_enc"], torch.cat([enc_feat, dec_feat], -1))
    scale = conv2d(p["scale"]["2"], F.leaky_relu(conv2d(p["scale"]["0"], h, padding=1), 0.2),
                   padding=1)
    shift = conv2d(p["shift"]["2"], F.leaky_relu(conv2d(p["shift"]["0"], h, padding=1), 0.2),
                   padding=1)
    return dec_feat + w * (dec_feat * scale + shift)


def _run_plan(plan, params: dict, x: torch.Tensor, fuse_at: Optional[dict] = None,
              collect: Optional[Dict[int, int]] = None):
    """Walk a block plan, collecting features at ``collect``'s indices (keyed
    by resolution) and fusing at ``fuse_at``'s."""
    collected: Dict[str, torch.Tensor] = {}
    collect_rev = {v: k for k, v in (collect or {}).items()}
    for i, (kind,) in enumerate(plan):
        p = params[str(i)]
        if kind in ("conv_in", "conv_out"):
            x = conv2d(p, x, padding=1)
        elif kind == "res":
            x = _res_block(p, x)
        elif kind == "attn":
            x = _attn_block(p, x)
        elif kind == "down":
            x = conv2d(p, F.pad(x, (0, 0, 0, 1, 0, 1)), stride=2)
        elif kind == "up":
            x = conv2d(p, upsample_nearest_2x(x), padding=1)
        elif kind == "norm":
            x = _swish(_norm(p, x))
        if i in collect_rev:
            collected[str(collect_rev[i])] = x
        if fuse_at and i in fuse_at:
            fp, enc_feat, w = fuse_at[i]
            x = _fuse_sft(fp, enc_feat, x, w)
    return x, collected


def _transformer_layer(p: dict, x: torch.Tensor, pos: torch.Tensor, heads: int) -> torch.Tensor:
    """TransformerSALayer (codeformer.py:492-533). x: (B, N, E)."""
    b, n, e = x.shape
    d = e // heads
    t2 = layer_norm(p["norm1"], x)
    qk = t2 + pos[None]
    w = p["self_attn"]["in_proj_weight"].to(x.dtype)
    bqkv = p["self_attn"]["in_proj_bias"].to(x.dtype)
    q = qk @ w[:e].T + bqkv[:e]
    k = qk @ w[e: 2 * e].T + bqkv[e: 2 * e]
    v = t2 @ w[2 * e:].T + bqkv[2 * e:]

    def heads_of(t):
        return t.reshape(b, n, heads, d).permute(0, 2, 1, 3)

    attn = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", heads_of(q) * (d ** -0.5), heads_of(k)),
                         dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, heads_of(v)).permute(0, 2, 1, 3).reshape(b, n, e)
    x = x + linear(p["self_attn"]["out_proj"], out)
    t2 = linear(p["linear2"], F.gelu(linear(p["linear1"], layer_norm(p["norm2"], x))))
    return x + t2


class CodeFormer:
    def __init__(self, config: CodeFormerConfig = CodeFormerConfig()):
        self.config = config
        self.enc_plan, self.enc_fuse = _encoder_plan(config)
        self.gen_plan, self.gen_fuse = _generator_plan(config)

    @property
    def scale(self) -> int:
        return 1

    def code_indices(self, params: dict, x: torch.Tensor):
        """The encoder and the transformer: (the codebook index of each
        latent token (B, N), the collected encoder features)."""
        cfg = self.config
        b, lr = x.shape[0], cfg.latent_res
        collect = {int(s): self.enc_fuse[int(s)] for s in cfg.connect_list}
        lq, enc_feats = _run_plan(self.enc_plan, params["encoder"]["blocks"], x, collect=collect)
        # the transformer over latent tokens (torch flattens channel-major)
        tokens = lq.permute(0, 3, 1, 2).reshape(b, cfg.emb_dim, lr * lr).transpose(1, 2)
        feat = linear(params["feat_emb"], tokens)
        pos = params["position_emb"].to(feat.dtype)
        for i in range(cfg.n_layers):
            feat = _transformer_layer(params["ft_layers"][str(i)], feat, pos, cfg.n_head)
        logits = layer_norm(params["idx_pred_layer"]["0"], feat)
        logits = logits @ params["idx_pred_layer"]["1"]["weight"].to(logits.dtype).T
        return torch.argmax(logits, dim=-1), enc_feats, logits

    def decode(self, params: dict, top_idx: torch.Tensor, enc_feats: dict, weight: float,
               dtype: torch.dtype) -> torch.Tensor:
        """The codebook lookup and the generator, fused with ``enc_feats``."""
        cfg = self.config
        b, lr = top_idx.shape[0], cfg.latent_res
        quant = params["quantize"]["embedding"]["weight"][top_idx]  # (B, N, emb)
        quant = quant.reshape(b, lr, lr, cfg.emb_dim)
        fuse_at = {}
        if weight > 0:
            for s in cfg.connect_list:
                fuse_at[self.gen_fuse[int(s)]] = (params["fuse_convs_dict"][s], enc_feats[s],
                                                  weight)
        out, _ = _run_plan(self.gen_plan, params["generator"]["blocks"], quant.to(dtype),
                           fuse_at=fuse_at)
        return out

    def apply(self, params: dict, x: torch.Tensor, weight: float = 0.5) -> torch.Tensor:
        """x: (B, S, S, 3) in [-1, 1] face crops -> the restored (B, S, S, 3).
        ``weight``: the fidelity knob (0 = the codebook prior alone, 1 = the
        most fidelity to the input, by SFT fusion)."""
        top_idx, enc_feats, _ = self.code_indices(params, x)
        return self.decode(params, top_idx, enc_feats, weight, x.dtype)

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32,
             device=None) -> dict:
        """Random init with the JAX package's tree and scales."""
        cfg = self.config
        d = Draws(generator, dtype, device)

        def res(i, o):
            p = {"norm1": d.norm(i), "conv1": d.conv(i, o), "norm2": d.norm(o),
                 "conv2": d.conv(o, o)}
            if i != o:
                p["conv_out"] = d.conv(i, o, 1)
            return p

        def attn(c):
            return {"norm": d.norm(c), "q": d.conv(c, c, 1), "k": d.conv(c, c, 1),
                    "v": d.conv(c, c, 1), "proj_out": d.conv(c, c, 1)}

        def build(plan, chan_walk):
            out = {}
            for i, (kind,) in enumerate(plan):
                cin, cout = chan_walk[i]
                if kind in ("conv_in", "conv_out", "up", "down"):
                    out[str(i)] = d.conv(cin, cout)
                elif kind == "res":
                    out[str(i)] = res(cin, cout)
                elif kind == "attn":
                    out[str(i)] = attn(cin)
                elif kind == "norm":
                    out[str(i)] = d.norm(cin)
            return out

        nf, cm = cfg.nf, cfg.ch_mult
        enc_ch = [(3, nf)]
        cin, curr_res = nf, cfg.img_size
        for i in range(len(cm)):
            for _ in range(cfg.res_blocks):
                enc_ch.append((cin, nf * cm[i]))
                cin = nf * cm[i]
                if curr_res in cfg.attn_resolutions:
                    enc_ch.append((cin, cin))
            if i != len(cm) - 1:
                enc_ch.append((cin, cin))
                curr_res //= 2
        enc_ch += [(cin, cin)] * 4 + [(cin, cfg.emb_dim)]

        cin, curr_res = nf * cm[-1], cfg.latent_res
        gen_ch = [(cfg.emb_dim, cin)] + [(cin, cin)] * 3
        for i in reversed(range(len(cm))):
            for _ in range(cfg.res_blocks):
                gen_ch.append((cin, nf * cm[i]))
                cin = nf * cm[i]
                if curr_res in cfg.attn_resolutions:
                    gen_ch.append((cin, cin))
            if i != 0:
                gen_ch.append((cin, cin))
                curr_res *= 2
        gen_ch += [(cin, cin), (cin, 3)]

        def fuse_block(c):
            return {"encode_enc": res(2 * c, c), "scale": {"0": d.conv(c, c), "2": d.conv(c, c)},
                    "shift": {"0": d.conv(c, c), "2": d.conv(c, c)}}

        # the encoder's width at each connect resolution
        conn_ch = {s: enc_ch[self.enc_fuse[int(s)]][1] for s in cfg.connect_list}
        e = cfg.dim_embd
        return {
            "encoder": {"blocks": build(self.enc_plan, enc_ch)},
            "generator": {"blocks": build(self.gen_plan, gen_ch)},
            "quantize": {"embedding": {"weight": d.normal((cfg.codebook_size, cfg.emb_dim),
                                                          0.05)}},
            "position_emb": d.zeros((cfg.latent_res ** 2, e)),
            "feat_emb": d.lin(cfg.emb_dim, e),
            "ft_layers": {str(i): {"self_attn": {"in_proj_weight": d.normal((3 * e, e), 0.05),
                                                 "in_proj_bias": d.zeros((3 * e,)),
                                                 "out_proj": d.lin(e, e)},
                                   "linear1": d.lin(e, 2 * e), "linear2": d.lin(2 * e, e),
                                   "norm1": d.norm(e), "norm2": d.norm(e)}
                          for i in range(cfg.n_layers)},
            "idx_pred_layer": {"0": d.norm(e), "1": d.lin(e, cfg.codebook_size, bias=False)},
            "fuse_convs_dict": {s: fuse_block(conn_ch[s]) for s in cfg.connect_list},
        }


def detect_codeformer_config(flat: Dict[str, torch.Tensor]) -> Optional[CodeFormerConfig]:
    if "position_emb" not in flat or "quantize.embedding.weight" not in flat:
        return None
    dim_embd = flat["position_emb"].shape[1]
    codebook, emb_dim = flat["quantize.embedding.weight"].shape
    n_layers = len({k.split(".")[1] for k in flat if k.startswith("ft_layers.")})
    n_head_exp = flat["ft_layers.0.self_attn.in_proj_weight"].shape[0] // dim_embd
    return CodeFormerConfig(codebook_size=codebook, emb_dim=emb_dim, dim_embd=dim_embd,
                            n_head=2 ** n_head_exp,  # the reference's guess (:630-633)
                            n_layers=n_layers)


def load_codeformer(path, device=None):
    """A CodeFormer checkpoint -> (CodeFormer, params on ``device``, default
    the card)."""
    from stable_renderer_tpu_torch.models.upscale import read_upscale_state, to_params

    flat = read_upscale_state(path)
    cfg = detect_codeformer_config(flat)
    if cfg is None:
        raise ValueError(f"{path} is not a CodeFormer checkpoint")
    return CodeFormer(cfg), to_params(flat, device)
