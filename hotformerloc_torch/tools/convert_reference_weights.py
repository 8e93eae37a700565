"""Convert reference HOTFormerLoc torch checkpoints to this package.

Counterpart of hotformerloc_tpu/tools/convert_reference_weights.py. Maps
the reference's ``model.state_dict()`` (its torch module tree) straight
onto this package's parameter names, so users of the reference can
evaluate their trained ``.pth`` / ``.ckpt`` weights with the port:

  python -m hotformerloc_torch.tools.convert_reference_weights \\
      --weights hotformerloc_oxford.pth \\
      --model_config configs/oxford_model.txt --octree_depth 9 \\
      --out weights/Oxford/converted.pt
  python -m hotformerloc_torch.evaluation.pnv_evaluate \\
      --config configs/oxford.txt --model_config configs/oxford_model.txt \\
      --weights weights/Oxford/converted.pt

Scope: the shipped configurations (PyramidAttnPoolMixer head, ADaPE,
single pyramid channel width -> no up/down projections, layernorm
conv_norm, no layer_scale). Transforms applied (torch's own layouts, so
fewer than the JAX converter's):
  * torch Linear weight (out, in) and bias: kept as they are;
  * torch LayerNorm weight/bias: kept as they are;
  * ocnn OctreeConv ``weights`` -> (kdim, Cin, Cout) ``kernel`` (reshaped
    from ocnn's flattened (kdim*Cin, Cout) if needed); missing conv biases
    (ocnn default use_bias=False) become zeros;
  * dwconv CPE ``weights`` (27, 1, C) -> (27, C, 1) ``dw_kernel``;
  * the HOTFormer blocks i = 0..num_blocks-1 go to
    ``backbone.hotf_stage.iters.<i>``, one module per iteration (no
    stacking).

Tap-order assumption: both frameworks enumerate 3x3x3 conv taps in
raster order (dz fastest; octree/neigh.py kernel_offsets) and stride-2
children in octant order 4x+2y+z. If a converted model shows degraded
accuracy, permute axis 0 of the conv kernels accordingly.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _normalize_key(k: str) -> str:
    """Real checkpoints nest HOTFormerBase under the HOTFormer wrapper
    (``backbone.backbone.*``); fold that onto the single ``backbone.*``
    namespace used below."""
    if k.startswith("backbone.backbone."):
        return "backbone." + k[len("backbone.backbone."):]
    return k


class Converter:
    """Reference state_dict (numpy values) -> {port name: fp32 tensor}."""

    def __init__(self, state_dict: Dict[str, np.ndarray], cfg):
        self.sd = {_normalize_key(k): np.asarray(v)
                   for k, v in state_dict.items()}
        self.cfg = cfg
        self.used = set()
        self.out: Dict[str, torch.Tensor] = {}

    # -- helpers ----------------------------------------------------------
    def take(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"reference checkpoint is missing '{key}'")
        self.used.add(key)
        return self.sd[key]

    def has(self, key: str) -> bool:
        return key in self.sd

    def put(self, name: str, value: np.ndarray) -> None:
        if name in self.out:
            raise KeyError(f"two reference entries map to {name}")
        self.out[name] = torch.from_numpy(
            np.ascontiguousarray(value, dtype=np.float32))

    def conv_kernel(self, key: str, kdim: int, cin: int,
                    cout: int) -> np.ndarray:
        w = self.take(key)
        if w.ndim == 2:                      # ocnn flattened (kdim*Cin, Cout)
            w = w.reshape(kdim, cin, cout)
        assert w.shape == (kdim, cin, cout), (key, w.shape)
        return w

    def map_conv(self, src: str, dst: str, kdim: int, cin: int, cout: int):
        """OctreeConvNormRelu / Downsample: conv.weights [+bias] + norm."""
        self.put(f"{dst}.kernel", self.conv_kernel(f"{src}.conv.weights",
                                                   kdim, cin, cout))
        self.put(f"{dst}.bias", self.take(f"{src}.conv.bias")
                 if self.has(f"{src}.conv.bias")
                 else np.zeros(cout, np.float32))
        self.map_norm(f"{src}.norm", f"{dst}.norm")

    def map_norm(self, src: str, dst: str):
        self.put(f"{dst}.weight", self.take(f"{src}.weight"))
        self.put(f"{dst}.bias", self.take(f"{src}.bias"))

    def map_linear(self, src: str, dst: str):
        self.put(f"{dst}.weight", self.take(f"{src}.weight"))
        if self.has(f"{src}.bias"):
            self.put(f"{dst}.bias", self.take(f"{src}.bias"))

    def map_cpe(self, src: str, dst: str, dim: int):
        w = self.take(f"{src}.conv.weights")
        assert w.size == 27 * dim, (src, w.shape)
        self.put(f"{dst}.dw_kernel", w.reshape(27, dim, 1))
        self.map_norm(f"{src}.norm", f"{dst}.norm")

    def map_window_block(self, src: str, dst: str, dim: int):
        """OctFormerBlock / HOTFormerBlock torch names -> the port's."""
        self.map_cpe(f"{src}.cpe", f"{dst}.cpe", dim)
        self.map_norm(f"{src}.norm1", f"{dst}.norm1")
        self.map_linear(f"{src}.attention.qkv", f"{dst}.attn.qkv")
        self.map_linear(f"{src}.attention.proj", f"{dst}.attn.proj")
        if self.has(f"{src}.attention.rpe.rpe_table"):
            self.put(f"{dst}.attn.rpe_table",
                     self.take(f"{src}.attention.rpe.rpe_table"))
        self.map_norm(f"{src}.norm2", f"{dst}.norm2")
        self.map_linear(f"{src}.mlp.fc1", f"{dst}.mlp.fc1")
        self.map_linear(f"{src}.mlp.fc2", f"{dst}.mlp.fc2")

    # -- model ------------------------------------------------------------
    def convert(self) -> Dict[str, torch.Tensor]:
        c = self.cfg
        octf_ch, pyr_ch = c.stage_channels()
        L = c.num_pyramid_levels
        nb = c.num_blocks[-1]
        max_ch = max(pyr_ch)

        # stem (PatchEmbed)
        chans = [int(c.channels[0] * 2 ** i)
                 for i in range(-c.stem_down, 1)]
        for i in range(c.stem_down):
            cin = c.in_channels if i == 0 else chans[i]
            self.map_conv(f"backbone.patch_embed.convs.{i}",
                          f"backbone.patch_embed.conv{i}", 27, cin, chans[i])
            self.map_conv(f"backbone.patch_embed.downsamples.{i}",
                          f"backbone.patch_embed.down{i}", 8, chans[i],
                          chans[i + 1])
        self.map_conv("backbone.patch_embed.proj",
                      "backbone.patch_embed.proj", 27, chans[-1],
                      c.channels[0])

        # octf stages + downsamples
        for i in range(c.num_octf_levels):
            dim = octf_ch[i]
            for k in range(c.num_blocks[i]):
                self.map_window_block(f"backbone.octf_stage.{i}.blocks.{k}",
                                      f"backbone.octf_stage{i}.block{k}",
                                      dim)
            nxt = (octf_ch + pyr_ch)[i + 1]
            self.map_conv(f"backbone.downsample.{i}",
                          f"backbone.octf_down{i}", 8, dim, nxt)

        # HOTFormer stage: block i of every kind -> iteration i
        hotf = "backbone.hotf_stage"
        for i in range(nb):
            it = f"{hotf}.iters.{i}"
            for j in range(L):
                self.map_window_block(f"{hotf}.hosa_blocks.{j}.{i}",
                                      f"{it}.hosa{j}", pyr_ch[j])
            src = f"{hotf}.rtsa_blocks.{i}"
            self.map_norm(f"{src}.norm1", f"{it}.rtsa.norm1")
            self.map_linear(f"{src}.rt_attention.qkv", f"{it}.rtsa.attn.qkv")
            self.map_linear(f"{src}.rt_attention.proj",
                            f"{it}.rtsa.attn.proj")
            self.map_norm(f"{src}.norm2", f"{it}.rtsa.norm2")
            self.map_linear(f"{src}.mlp.fc1", f"{it}.rtsa.mlp.fc1")
            self.map_linear(f"{src}.mlp.fc2", f"{it}.rtsa.mlp.fc2")

        if c.adape_mode:
            self.map_linear(f"{hotf}.rt_adape.mlp.fc1",
                            f"{hotf}.rt_adape.mlp.fc1")
            self.map_linear(f"{hotf}.rt_adape.mlp.fc2",
                            f"{hotf}.rt_adape.mlp.fc2")
        elif c.use_projections:
            # No ADaPE -> the relay-token initialiser carries a CPE
            for j in range(L):
                self.map_cpe(f"{hotf}.relay_tokeniser.{j}.cpe",
                             f"{hotf}.rt_init_cpe{j}", pyr_ch[j])
        else:
            self.map_cpe(f"{hotf}.relay_tokeniser.cpe",
                         f"{hotf}.rt_init_cpe", max_ch)
        for j in range(L - 1):
            self.map_conv(f"{hotf}.downsamples.{j}",
                          f"{hotf}.downsample{j}", 8, pyr_ch[j],
                          pyr_ch[j + 1])

        # pooling head (PyramidAttnPoolWrapper)
        if c.pooling != "PyramidAttnPoolMixer":
            raise NotImplementedError(
                f"conversion for pooling={c.pooling} not implemented")
        for j in range(L):
            self.put(f"pooling.attpool{j}.query",
                     self.take(f"pooling.pooling.attpool.{j}.query"))
        for m in range(4):                   # the mixer's depth
            base = f"pooling.pooling.descriptor_extractor.mix.{m}.mix"
            dst = f"pooling.mixer.mix{m}"
            self.map_norm(f"{base}.0", f"{dst}.norm1")
            self.map_linear(f"{base}.1", f"{dst}.fc1")
            self.map_linear(f"{base}.3", f"{dst}.fc2")
        self.map_linear("pooling.pooling.descriptor_extractor.row_proj",
                        "pooling.mixer.row_proj")
        self.map_linear("pooling.pooling.descriptor_extractor.channel_proj",
                        "pooling.mixer.channel_proj")

        unused = [k for k in self.sd
                  if k not in self.used and "num_batches_tracked" not in k]
        if unused:
            print(f"[convert] WARNING: {len(unused)} reference params "
                  f"unused, e.g. {unused[:5]}")
        return self.out


def convert_state_dict(state_dict: Dict[str, np.ndarray],
                       cfg) -> Dict[str, torch.Tensor]:
    """Reference torch state_dict (numpy values) -> the port's state_dict
    (fp32 CPU tensors by parameter name)."""
    return Converter(state_dict, cfg).convert()


def validate(state: Dict[str, torch.Tensor], model: torch.nn.Module) -> None:
    """Raise unless ``state`` has exactly ``model.state_dict()``'s keys,
    each with its shape."""
    ref = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    new = {k: tuple(v.shape) for k, v in state.items()}
    missing = sorted(set(ref) - set(new))
    extra = sorted(set(new) - set(ref))
    bad = sorted(k for k in set(ref) & set(new) if ref[k] != new[k])
    if missing or extra or bad:
        raise ValueError(
            f"converted state mismatch: missing={missing[:8]} "
            f"extra={extra[:8]} shape={[(k, ref[k], new[k]) for k in bad[:8]]}")


def synthesize_reference_state_dict(cfg, seed: int = 0
                                    ) -> Dict[str, np.ndarray]:
    """Random state_dict with the reference's exact key names and shapes
    (for differential tests without the reference's torch model): this
    package's copy of the JAX converter's."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def add(key, *shape):
        sd[key] = rng.normal(0, 0.02, shape).astype(np.float32)

    def add_linear(base, cin, cout, bias=True):
        add(f"{base}.weight", cout, cin)
        if bias:
            add(f"{base}.bias", cout)

    def add_norm(base, dim):
        add(f"{base}.weight", dim)
        add(f"{base}.bias", dim)

    def add_conv(base, kdim, cin, cout, bias=False, norm=True):
        add(f"{base}.conv.weights", kdim * cin, cout)   # ocnn flattened
        if bias:
            add(f"{base}.conv.bias", cout)
        if norm:
            add_norm(f"{base}.norm", cout)

    def add_block(base, dim, heads, K, D):
        add_norm(f"{base}.norm1", dim)
        add_linear(f"{base}.attention.qkv", dim, 3 * dim)
        add_linear(f"{base}.attention.proj", dim, dim)
        bnd = int(0.8 * K * D ** 0.5)
        add(f"{base}.attention.rpe.rpe_table", 3 * (2 * bnd + 1), heads)
        add_norm(f"{base}.norm2", dim)
        hid = int(dim * cfg.mlp_ratio)
        add_linear(f"{base}.mlp.fc1", dim, hid)
        add_linear(f"{base}.mlp.fc2", hid, dim)
        sd[f"{base}.cpe.conv.weights"] = rng.normal(
            0, 0.02, (27, 1, dim)).astype(np.float32)   # dwconv layout
        add_norm(f"{base}.cpe.norm", dim)

    c = cfg
    octf_ch, pyr_ch = c.stage_channels()
    octf_h, pyr_h = c.stage_heads()
    L = c.num_pyramid_levels
    nb = c.num_blocks[-1]
    K = c.patch_size

    chans = [int(c.channels[0] * 2 ** i) for i in range(-c.stem_down, 1)]
    for i in range(c.stem_down):
        cin = c.in_channels if i == 0 else chans[i]
        add_conv(f"backbone.backbone.patch_embed.convs.{i}", 27, cin, chans[i])
        add_conv(f"backbone.backbone.patch_embed.downsamples.{i}", 8, chans[i],
                 chans[i + 1])
    add_conv("backbone.backbone.patch_embed.proj", 27, chans[-1], c.channels[0])

    for i in range(c.num_octf_levels):
        for k in range(c.num_blocks[i]):
            add_block(f"backbone.backbone.octf_stage.{i}.blocks.{k}", octf_ch[i],
                      octf_h[i], K, 1 if k % 2 == 0 else c.dilation)
        add_conv(f"backbone.backbone.downsample.{i}", 8, octf_ch[i],
                 (octf_ch + pyr_ch)[i + 1], bias=True)

    for j in range(L):
        for i in range(nb):
            add_block(f"backbone.backbone.hotf_stage.hosa_blocks.{j}.{i}",
                      pyr_ch[j], pyr_h[j], K, 1)
    max_ch = max(pyr_ch)
    for i in range(nb):
        base = f"backbone.backbone.hotf_stage.rtsa_blocks.{i}"
        add_norm(f"{base}.norm1", max_ch)
        add_linear(f"{base}.rt_attention.qkv", max_ch, 3 * max_ch)
        add_linear(f"{base}.rt_attention.proj", max_ch, max_ch)
        add_norm(f"{base}.norm2", max_ch)
        hid = int(max_ch * c.mlp_ratio)
        add_linear(f"{base}.mlp.fc1", max_ch, hid)
        add_linear(f"{base}.mlp.fc2", hid, max_ch)
    if c.adape_mode:
        in_feat = {"pos": 3, "var": 6, "cov": 9}[c.adape_mode]
        add_linear("backbone.backbone.hotf_stage.rt_adape.mlp.fc1", in_feat,
                   max_ch)
        add_linear("backbone.backbone.hotf_stage.rt_adape.mlp.fc2", max_ch,
                   max_ch)
    else:
        base = "backbone.backbone.hotf_stage.relay_tokeniser"
        sd[f"{base}.cpe.conv.weights"] = rng.normal(
            0, 0.02, (27, 1, max_ch)).astype(np.float32)
        add_norm(f"{base}.cpe.norm", max_ch)
    for j in range(L - 1):
        add_conv(f"backbone.backbone.hotf_stage.downsamples.{j}", 8, pyr_ch[j],
                 pyr_ch[j + 1], bias=True)

    for j in range(L):
        add(f"pooling.pooling.attpool.{j}.query", c.k_pooled_tokens[j],
            pyr_ch[j])
    fs = c.feature_size
    for m in range(4):
        base = f"pooling.pooling.descriptor_extractor.mix.{m}.mix"
        add_norm(f"{base}.0", fs)
        add_linear(f"{base}.1", fs, fs)
        add_linear(f"{base}.3", fs, fs)
    k_out = sum(c.k_pooled_tokens) // 4
    add_linear("pooling.pooling.descriptor_extractor.row_proj", fs,
               c.output_dim // k_out)
    add_linear("pooling.pooling.descriptor_extractor.channel_proj",
               sum(c.k_pooled_tokens), k_out)
    return sd


def load_reference(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` (bare state_dict) or ``.ckpt`` (its
    ``"model"`` entry) as numpy arrays."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """Convert ``--weights`` and write the port's state_dict to ``--out``
    (a ``torch.save`` file that ``pnv_evaluate --weights`` loads).
    Returns the state_dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", required=True,
                    help="reference .pth (bare state_dict) or .ckpt")
    ap.add_argument("--model_config", required=True)
    ap.add_argument("--octree_depth", type=int, default=9)
    ap.add_argument("--num_points", type=int, default=4096)
    ap.add_argument("--out", required=True, help="output state_dict file")
    args = ap.parse_args(argv)

    from hotformerloc_torch.config.params import parse_model_config
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    cfg = parse_model_config(args.model_config,
                             octree_depth=args.octree_depth,
                             num_points=args.num_points).config
    state = convert_state_dict(load_reference(args.weights), cfg)
    validate(state, HOTFormerLoc(cfg, device="cpu"))
    torch.save(state, args.out)
    n = sum(v.numel() for v in state.values())
    print(f"converted {n:,} parameters -> {args.out}")
    return state


if __name__ == "__main__":
    main()
