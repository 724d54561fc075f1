"""Reference state-dict name -> JAX variable path map (the port's own copy).

``translate`` and ``translate_discriminator`` are copied from
``detail_tts_tpu/io/torch_convert.py``: they map a reference
``SynthesizerTrn`` (or ``MultiPeriodDiscriminator``) state-dict name onto
the JAX package's ``params/...`` (or ``vq_state/...``) path and the layout
transform between the two.  Every transform of ``translate`` is a transpose that is its own inverse, so the
same map carries JAX variables into the port (``io/weights.py``).

Layouts: torch Conv1d (out, in/g, k) and ConvTranspose1d (in, out, k) <->
flax (k, in/g, out) / (k, out, in), both axes (2, 1, 0); torch Linear
(out, in) <-> Dense (in, out); HF GPT-2 Conv1D (in, out) as it is; norm
weight/gamma <-> scale, bias/beta <-> bias.  The one transform that is not
its own inverse, ``translate_discriminator``'s for Conv2d, is written in
the direction the port uses, flax (kh, kw, in/g, out) -> torch (out, in/g,
kh, kw).
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

# transforms -----------------------------------------------------------------


def t_conv(w):  # torch conv / conv-transpose -> flax
    return np.transpose(w, (2, 1, 0))


def t_linear(w):
    return np.transpose(w)


def t_id(w):
    return w


IGNORED = (
    "gpt.gpt.wte.",
    "gpt.inference_model.",
    "diffusion.code_embedding.",
    "diffusion.code_converter.",
    "diffusion.mel_head.",
)

# ---------------------------------------------------------------------------
# Name translation
# ---------------------------------------------------------------------------


def _norm_suffix(leaf: str) -> Optional[str]:
    return {"weight": "scale", "bias": "bias",
            "gamma": "scale", "beta": "bias"}.get(leaf)


def _style_encoder(rest: str, base: str) -> Optional[Tuple[str, Callable]]:
    """MelStyleEncoder submap (modules.py:642-720)."""
    m = re.fullmatch(r"spectral\.(0|3)\.fc\.(weight|bias)", rest)
    if m:
        idx = "0" if m.group(1) == "0" else "1"
        return (f"{base}/spectral_{idx}/dense/"
                + ("kernel" if m.group(2) == "weight" else "bias"),
                t_linear if m.group(2) == "weight" else t_id)
    m = re.fullmatch(r"temporal\.(\d)\.conv1\.conv\.(weight|bias)", rest)
    if m:
        return (f"{base}/temporal_{m.group(1)}/conv/conv/"
                + ("kernel" if m.group(2) == "weight" else "bias"),
                t_conv if m.group(2) == "weight" else t_id)
    m = re.fullmatch(r"slf_attn\.(w_qs|w_ks|w_vs|fc)\.(weight|bias)", rest)
    if m:
        return (f"{base}/slf_attn/{m.group(1)}/dense/"
                + ("kernel" if m.group(2) == "weight" else "bias"),
                t_linear if m.group(2) == "weight" else t_id)
    m = re.fullmatch(r"fc\.fc\.(weight|bias)", rest)
    if m:
        return (f"{base}/fc/dense/"
                + ("kernel" if m.group(1) == "weight" else "bias"),
                t_linear if m.group(1) == "weight" else t_id)
    return None


def _conv_entry(base: str, leaf: str) -> Tuple[str, Callable]:
    return (f"{base}/conv/" + ("kernel" if leaf == "weight" else "bias"),
            t_conv if leaf == "weight" else t_id)


def _wn(rest: str, base: str) -> Optional[Tuple[str, Callable]]:
    """WaveNet ``enc`` submap (modules.py:152-237)."""
    m = re.fullmatch(r"(in_layers|res_skip_layers|cond_layer)"
                     r"(?:\.(\d+))?\.(weight|bias)", rest)
    if not m:
        return None
    group, idx, leaf = m.groups()
    sub = {"in_layers": f"in_{idx}", "res_skip_layers": f"res_skip_{idx}",
           "cond_layer": "cond_layer"}[group]
    return _conv_entry(f"{base}/{sub}", leaf)


def _diff_resblock(rest: str, base: str) -> Optional[Tuple[str, Callable]]:
    """diff_model ResBlock submap (diff_model.py:59-120)."""
    m = re.fullmatch(r"in_layers\.(0|2)\.(weight|bias)", rest)
    if m:
        if m.group(1) == "0":
            return f"{base}/in_norm/GroupNorm_0/{_norm_suffix(m.group(2))}", t_id
        return _conv_entry(f"{base}/in_conv", m.group(2))
    m = re.fullmatch(r"out_layers\.(0|3)\.(weight|bias)", rest)
    if m:
        if m.group(1) == "0":
            return f"{base}/out_norm/GroupNorm_0/{_norm_suffix(m.group(2))}", t_id
        return _conv_entry(f"{base}/out_conv", m.group(2))
    m = re.fullmatch(r"emb_layers\.1\.(weight|bias)", rest)
    if m:
        return (f"{base}/emb/dense/"
                + ("kernel" if m.group(1) == "weight" else "bias"),
                t_linear if m.group(1) == "weight" else t_id)
    return None


def _diff_attn(rest: str, base: str) -> Optional[Tuple[str, Callable]]:
    """diff_util AttentionBlock submap (diff_util.py:172-231)."""
    m = re.fullmatch(r"norm\.(weight|bias)", rest)
    if m:
        return f"{base}/norm/GroupNorm_0/{_norm_suffix(m.group(1))}", t_id
    m = re.fullmatch(r"(qkv|proj_out)\.(weight|bias)", rest)
    if m:
        return _conv_entry(f"{base}/{m.group(1)}", m.group(2))
    if rest == "relative_pos_embeddings.relative_attention_bias.weight":
        return f"{base}/rel_pos/embedding", t_id
    return None


def translate(name: str, diffusion_layers: int = 10
              ) -> Optional[Tuple[str, Callable]]:
    """Reference state-dict name -> ('params/...' path, transform) or None.

    ``diffusion_layers``: the checkpoint's ``diffusion.num_layers`` — the
    reference appends 3 plain ResBlocks AFTER that many DiffusionLayers in
    one ``layers`` list (diff_model.py:202-203), so trailing-block indices
    are relative to it.
    """
    for pre in IGNORED:
        if name.startswith(pre):
            return None

    # ---- quantizer (quantize.py / core_vq.py)
    m = re.fullmatch(r"quantizer\.vq\.layers\.(\d+)\._codebook\.(\w+)", name)
    if m:
        return f"vq_state/quantizer/layer_{m.group(1)}/codebook/{m.group(2)}", t_id
    m = re.fullmatch(r"quantizer\.vq\.layers\.(\d+)\.(project_in|project_out)"
                     r"\.(weight|bias)", name)
    if m:
        return (f"params/quantizer/layer_{m.group(1)}/{m.group(2)}/dense/"
                + ("kernel" if m.group(3) == "weight" else "bias"),
                t_linear if m.group(3) == "weight" else t_id)

    # ---- vq_enc / vq_dec sequentials (model_24k.py:606-627)
    m = re.fullmatch(r"vq_(enc|dec)\.(\d)\.(weight|bias)", name)
    if m:
        kind, idx, leaf = m.groups()
        if idx == "1":
            return (f"params/vq_{kind}_norm/LayerNorm_0/"
                    f"{'scale' if leaf == 'weight' else 'bias'}", t_id)
        if kind == "enc":
            sub = {"3": "vq_enc_conv0", "5": "vq_enc_conv1",
                   "7": "vq_enc_conv2"}[idx]
            return _conv_entry(f"params/{sub}", leaf)
        if idx in ("3", "5"):  # ConvTranspose1d: params live directly
            sub = {"3": "vq_dec_up0", "5": "vq_dec_up1"}[idx]
            return (f"params/{sub}/" + ("kernel" if leaf == "weight" else "bias"),
                    t_conv if leaf == "weight" else t_id)
        return _conv_entry("params/vq_dec_conv", leaf)

    # ---- top-level convs
    m = re.fullmatch(r"in_proj\.(weight|bias)", name)
    if m:
        return _conv_entry("params/in_proj", m.group(1))

    # ---- style encoders
    for ref, mine in (("ref_enc.", "params/ref_enc"),
                      ("vq_ref_enc.", "params/vq_ref_enc"),
                      ("gpt.conditioning_encoder.",
                       "params/gpt/conditioning_encoder")):
        if name.startswith(ref):
            return _style_encoder(name[len(ref):], mine)

    # ---- enc_p (SpecEncoder, model_24k.py:71-124)
    m = re.fullmatch(r"enc_p\.encoder\.attn_layers\.(\d+)\.conv_([qkvo])"
                     r"\.(weight|bias)", name)
    if m:
        return _conv_entry(
            f"params/enc_p/encoder/attn_{m.group(1)}/conv_{m.group(2)}",
            m.group(3))
    m = re.fullmatch(r"enc_p\.encoder\.attn_layers\.(\d+)\.(emb_rel_[kv])", name)
    if m:
        return f"params/enc_p/encoder/attn_{m.group(1)}/{m.group(2)}", t_id
    m = re.fullmatch(r"enc_p\.encoder\.ffn_layers\.(\d+)\.(conv_[12])"
                     r"\.(weight|bias)", name)
    if m:
        return _conv_entry(
            f"params/enc_p/encoder/ffn_{m.group(1)}/{m.group(2)}", m.group(3))
    m = re.fullmatch(r"enc_p\.encoder\.norm_layers_([12])\.(\d+)\.(gamma|beta)",
                     name)
    if m:
        return (f"params/enc_p/encoder/norm{m.group(1)}_{m.group(2)}"
                f"/LayerNorm_0/{_norm_suffix(m.group(3))}", t_id)
    m = re.fullmatch(r"enc_p\.(out_proj|proj)\.(weight|bias)", name)
    if m:
        return _conv_entry(f"params/enc_p/{m.group(1)}", m.group(2))

    # ---- enc_q (PosteriorEncoder)
    m = re.fullmatch(r"enc_q\.(pre|proj)\.(weight|bias)", name)
    if m:
        return _conv_entry(f"params/enc_q/{m.group(1)}", m.group(2))
    if name.startswith("enc_q.enc."):
        return _wn(name[len("enc_q.enc."):], "params/enc_q/enc")

    # ---- flow (couplings at even indices; Flip has no params)
    m = re.fullmatch(r"flow\.flows\.(\d+)\.(.*)", name)
    if m:
        base = f"params/flow/flow_{int(m.group(1)) // 2}"
        rest = m.group(2)
        mm = re.fullmatch(r"(pre|post)\.(weight|bias)", rest)
        if mm:
            return _conv_entry(f"{base}/{mm.group(1)}", mm.group(2))
        if rest.startswith("enc."):
            return _wn(rest[4:], f"{base}/enc")
        return None

    # ---- dec (HiFi-GAN Generator)
    m = re.fullmatch(r"dec\.(conv_pre|conv_post|cond)\.(weight|bias)", name)
    if m:
        return _conv_entry(f"params/dec/{m.group(1)}", m.group(2))
    m = re.fullmatch(r"dec\.ups\.(\d+)\.(weight|bias)", name)
    if m:
        return (f"params/dec/ups_{m.group(1)}/"
                + ("kernel" if m.group(2) == "weight" else "bias"),
                t_conv if m.group(2) == "weight" else t_id)
    m = re.fullmatch(r"dec\.resblocks\.(\d+)\.(convs[12])\.(\d+)\.(weight|bias)",
                     name)
    if m:
        return _conv_entry(
            f"params/dec/resblocks_{m.group(1)}/{m.group(2)}_{m.group(3)}",
            m.group(4))

    # ---- GPT (UnifiedVoice)
    m = re.fullmatch(r"gpt\.(text|mel)_embedding\.weight", name)
    if m:
        return f"params/gpt/{m.group(1)}_embedding/embedding", t_id
    m = re.fullmatch(r"gpt\.(text|mel)_pos_embedding\.emb\.weight", name)
    if m:
        return f"params/gpt/{m.group(1)}_pos_embedding/embedding", t_id
    m = re.fullmatch(r"gpt\.final_norm\.(weight|bias)", name)
    if m:
        return f"params/gpt/final_norm/{_norm_suffix(m.group(1))}", t_id
    m = re.fullmatch(r"gpt\.(text|mel)_head\.(weight|bias)", name)
    if m:
        return (f"params/gpt/{m.group(1)}_head/dense/"
                + ("kernel" if m.group(2) == "weight" else "bias"),
                t_linear if m.group(2) == "weight" else t_id)
    m = re.fullmatch(r"gpt\.gpt\.ln_f\.(weight|bias)", name)
    if m:
        return f"params/gpt/gpt/ln_f/{_norm_suffix(m.group(1))}", t_id
    m = re.fullmatch(r"gpt\.gpt\.h\.(\d+)\.(ln_[12])\.(weight|bias)", name)
    if m:
        return (f"params/gpt/gpt/h_{m.group(1)}/{m.group(2)}/"
                f"{_norm_suffix(m.group(3))}", t_id)
    m = re.fullmatch(r"gpt\.gpt\.h\.(\d+)\.attn\.(c_attn|c_proj)"
                     r"\.(weight|bias)", name)
    if m:  # HF Conv1D: weight already (in, out)
        return (f"params/gpt/gpt/h_{m.group(1)}/attn/{m.group(2)}/dense/"
                + ("kernel" if m.group(3) == "weight" else "bias"), t_id)
    m = re.fullmatch(r"gpt\.gpt\.h\.(\d+)\.mlp\.(c_fc|c_proj)"
                     r"\.(weight|bias)", name)
    if m:
        return (f"params/gpt/gpt/h_{m.group(1)}/{m.group(2)}/dense/"
                + ("kernel" if m.group(3) == "weight" else "bias"), t_id)

    # ---- diffusion (DiffusionTts)
    if name == "diffusion.unconditioned_embedding":
        return "params/diffusion/unconditioned_embedding", lambda w: np.transpose(w, (0, 2, 1))
    m = re.fullmatch(r"diffusion\.(inp_block|integrating_conv)\.(weight|bias)",
                     name)
    if m:
        return _conv_entry(f"params/diffusion/{m.group(1)}", m.group(2))
    m = re.fullmatch(r"diffusion\.time_embed\.(0|2)\.(weight|bias)", name)
    if m:
        idx = "0" if m.group(1) == "0" else "1"
        return (f"params/diffusion/time_embed_{idx}/dense/"
                + ("kernel" if m.group(2) == "weight" else "bias"),
                t_linear if m.group(2) == "weight" else t_id)
    m = re.fullmatch(r"diffusion\.code_norm\.(weight|bias)", name)
    if m:
        return (f"params/diffusion/code_norm/GroupNorm_0/"
                f"{_norm_suffix(m.group(1))}", t_id)
    m = re.fullmatch(r"diffusion\.out\.(0|2)\.(weight|bias)", name)
    if m:
        if m.group(1) == "0":
            return (f"params/diffusion/out_norm/GroupNorm_0/"
                    f"{_norm_suffix(m.group(2))}", t_id)
        return _conv_entry("params/diffusion/out_conv", m.group(2))
    m = re.fullmatch(r"diffusion\.latent_conditioner\.(\d+)\.(.*)", name)
    if m:
        idx, rest = int(m.group(1)), m.group(2)
        if idx == 0:  # the stride-1 conv
            mm = re.fullmatch(r"(weight|bias)", rest)
            return _conv_entry("params/diffusion/latent_conditioner_conv",
                               mm.group(1)) if mm else None
        return _diff_attn(rest, f"params/diffusion/latent_conditioner_{idx - 1}")
    m = re.fullmatch(r"diffusion\.contextual_embedder\.(\d+)\.(.*)", name)
    if m:
        idx, rest = int(m.group(1)), m.group(2)
        if idx in (0, 1):
            mm = re.fullmatch(r"(weight|bias)", rest)
            return _conv_entry(
                f"params/diffusion/contextual_embedder_conv{idx}",
                mm.group(1)) if mm else None
        return _diff_attn(rest, f"params/diffusion/contextual_embedder_{idx - 2}")
    m = re.fullmatch(r"diffusion\.conditioning_timestep_integrator\.(\d+)"
                     r"\.(attn|resblk)\.(.*)", name)
    if m:
        base = f"params/diffusion/cond_integrator_{m.group(1)}"
        if m.group(2) == "attn":
            return _diff_attn(m.group(3), f"{base}/attn")
        return _diff_resblock(m.group(3), f"{base}/resblk")
    m = re.fullmatch(r"diffusion\.layers\.(\d+)\.(.*)", name)
    if m:
        idx, rest = int(m.group(1)), m.group(2)
        if rest.startswith("attn."):
            return _diff_attn(rest[5:], f"params/diffusion/layer_{idx}/attn")
        if rest.startswith("resblk."):
            return _diff_resblock(rest[7:],
                                  f"params/diffusion/layer_{idx}/resblk")
        # plain trailing ResBlocks (indices >= num DiffusionLayers)
        return _diff_resblock(
            rest, f"params/diffusion/layer_res_{idx - diffusion_layers}")

    return None


def t_conv2d(w):  # flax (kh, kw, in/g, out) -> torch Conv2d (out, in/g, kh, kw)
    return np.transpose(w, (3, 2, 0, 1))


_DISC_PERIODS = (2, 3, 5, 7, 11)


def translate_discriminator(name: str) -> Optional[Tuple[str, Callable]]:
    """Reference ``MultiPeriodDiscriminator`` state-dict name ->
    ('params/...' path, transform) or None.

    ``discriminators.0`` is DiscriminatorS (1-D convs), ``discriminators.1..5``
    the DiscriminatorP of periods (2, 3, 5, 7, 11) (2-D convs)
    (vqvae/model_24k.py:407-431)."""
    m = re.fullmatch(r"discriminators\.(\d)\.(convs\.(\d)|conv_post)"
                     r"\.(weight|bias)", name)
    if not m:
        return None
    idx = int(m.group(1))
    sub = "conv_post" if m.group(2) == "conv_post" else f"conv_{m.group(3)}"
    leaf = "kernel" if m.group(4) == "weight" else "bias"
    if idx == 0:  # DiscriminatorS: the Conv1d wrapper nests its conv as 'conv'
        return (f"params/disc_s/{sub}/conv/{leaf}",
                t_conv if leaf == "kernel" else t_id)
    return (f"params/disc_p{_DISC_PERIODS[idx - 1]}/{sub}/{leaf}",
            t_conv2d if leaf == "kernel" else t_id)
