"""The plain serving computation of one batch row, from the request's text
and prompt waveform and the codes the program served.

What the engine derives (text ids, bucket widths, prompt mels, the GPT
latents, the diffusion conditioning and code embedding, the T5 biases, the
sampler's noise and the vocoder's prior noise) is worked out again here,
in the reference's own precision, from the inputs and the request's key:
the key splits into the decode's, the diffusion's and the vocoder's keys
(``g, d, v = split(key, 3)``), and a draw's elements depend on the key and
their flat index only, so row r of a batch draws alone from its offset.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from port_bench.reference import prng
from port_bench.reference.config import Config
from port_bench.reference.diffusion import (ddim_sample_loop, dpmpp_2m_reference_sample_loop,
                                            dpmpp_2m_sample_loop, p_sample_loop)
from port_bench.reference.mel import FRAMES_PER_CODE, MelFrontend, denormalize_mel
from port_bench.reference.mesh import Rows
from port_bench.reference.pinyin import to_pinyin
from port_bench.reference.synthesizer import SynthesizerTrn, make_infer_schedule
from port_bench.reference.tokenizer import make_tokenizer


def bucket_up(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


# the serving settings a configuration's ``engine`` section leaves out: the
# reference's shipped ones
ENGINE_DEFAULTS = {
    "temperature": 0.8, "top_p": 0.8, "repetition_penalty": 2.0,
    "max_generate_length": 600, "typical_mass": 1.0, "noise_scale": 0.667,
    "diffusion_temperature": 1.0, "diffusion_sampler": "ancestral", "diffusion_steps": None,
    "text_buckets": (32, 64, 128, 256, 512, 800),
    "prompt_buckets": (64, 128, 256, 512, 1024, 1600),
    "code_buckets": (100, 200, 300, 400, 500, 600),
}


def clamp_buckets(cfg: Config, engine: Dict) -> Dict:
    """The engine's settings over the defaults, its buckets and decode length
    capped at the GPT's tables."""
    engine = {**ENGINE_DEFAULTS, **engine}
    mel_cap, txt_cap = cfg.gpt.max_mel_tokens, cfg.gpt.max_text_tokens
    text = tuple(engine["text_buckets"])
    if text[-1] > txt_cap:
        text = tuple(b for b in text if b < txt_cap) + (txt_cap,)
    return dict(engine, text_buckets=text,
                max_generate_length=min(engine["max_generate_length"], mel_cap),
                code_buckets=tuple(b for b in engine["code_buckets"] if b <= mel_cap)
                or (mel_cap,))


def text_ids(tokenizer, e: Dict, texts: Sequence[str]) -> np.ndarray:
    """(B, width) int64: pinyin -> BPE, cut to the largest bucket less one,
    stop-padded (0) to the batch's bucket."""
    cap = e["text_buckets"][-1] - 1
    enc = [tokenizer.encode(to_pinyin(t))[:cap] for t in texts]
    width = bucket_up(max(len(x) for x in enc) + 1, e["text_buckets"])
    out = np.zeros((len(texts), width), np.int64)
    for i, x in enumerate(enc):
        out[i, :len(x)] = x
    return out


def prompt_frames(cfg: Config, e: Dict, wavs: Sequence[np.ndarray]) -> List[int]:
    """Each prompt's frames, cut to the largest prompt bucket."""
    cap = e["prompt_buckets"][-1]
    return [min(len(w) // cfg.data.hop_length, cap) for w in wavs]


def batch_shapes(cfg: Config, engine: Dict, texts: Sequence[str],
                 wavs: Sequence[np.ndarray]) -> Dict:
    """The sizes the engine runs a batch at: rows, text and prompt widths,
    each row's conditioning bucket, the decode's length and the code bucket."""
    e = clamp_buckets(cfg, engine)
    frames = prompt_frames(cfg, e, wavs)
    width = bucket_up(max(frames), e["prompt_buckets"])
    max_len = e["max_generate_length"]
    eff = max(max_len - 1, 1)
    return {"n": len(texts), "text_width": text_ids(make_tokenizer(cfg.data.tokenizer_vocab),
                                                     e, texts).shape[1],
            "prompt_width": width, "max_len": max_len,
            "cond_buckets": [min(bucket_up(f, e["prompt_buckets"]), width) for f in frames],
            "code_bucket": min(bucket_up(eff, e["code_buckets"]), max_len),
            "steps": e.get("diffusion_steps") or cfg.diffusion.infer_steps}


def meta_work(model: SynthesizerTrn, cfg: Config, engine: Dict, shapes: Dict):
    """(the diffusion's bias-attention calls (B, T, H, d), the model FLOPs)
    of one batch at ``shapes``, from the reference run on the ``meta``
    device: the decode counted as one pass over its prefix and codes, the
    GPT latents, the conditioning, the code embedding, every sampler step's
    CFG call, and the vocoder."""
    from port_bench.reference.diff_blocks import AttentionBlock
    from port_bench.roofline import attention_calls, count_flops

    model = model.eval()
    n, dev, c = shapes["n"], torch.device("meta"), cfg
    text = torch.zeros((n, shapes["text_width"]), dtype=torch.long, device=dev)
    refer = torch.zeros((n, shapes["prompt_width"], c.data.n_mel_channels), device=dev)
    refer_len = torch.full((n,), shapes["prompt_width"], device=dev)
    codes = torch.zeros((n, shapes["max_len"]), dtype=torch.long, device=dev)
    bucket = shapes["code_bucket"]
    frames = bucket * FRAMES_PER_CODE
    gpt = model.gpt
    box = {}

    def decode():
        prefix = gpt.prefill_embeddings(refer, refer_len, text)
        pos = torch.arange(1, codes.shape[1], device=dev)[None]
        hidden = gpt.gpt(torch.cat([prefix, gpt._mel_embeddings(codes[:, :-1], pos)], 1))
        gpt._logits(gpt.final_norm(hidden[:, prefix.shape[1] - 1:]))

    def latents():
        wav_len = torch.full((n,), bucket * c.gpt.mel_length_compression, device=dev)
        box["latents"] = gpt(refer, refer_len, text, codes[:, :bucket], wav_len)

    def cond():
        outs = []
        for lb in sorted(set(shapes["cond_buckets"])):
            k = shapes["cond_buckets"].count(lb)
            outs.append(model.diffusion_conditioning(refer[:k, :lb]))
        box["cond"] = torch.cat(outs)

    def code_emb():
        box["code_emb"] = model.diffusion_code_embedding(box["latents"], box["cond"])

    def step():
        x = torch.zeros((2 * n, frames, c.diffusion.in_channels), device=dev)
        t = torch.zeros((2 * n,), dtype=torch.long, device=dev)
        biases = [torch.zeros((c.diffusion.num_heads, frames, frames), device=dev)
                  for _ in range(3 + c.diffusion.num_layers)]
        model.diffusion_cfg_step(x, t, box["code_emb"], biases)

    def vocode():
        mel = torch.zeros((n, frames, c.data.n_mel_channels), device=dev)
        lengths = torch.full((n,), frames, device=dev)
        noise = torch.zeros((n, frames, c.vaegan.inter_channels), device=dev)
        model.infer_flowvae(mel, lengths, engine.get("noise_scale", 0.667), noise=noise)

    flops, calls = 0.0, []
    with torch.no_grad():
        for fn, times in ((decode, 1), (latents, 1), (cond, 1), (code_emb, 1),
                          (step, shapes["steps"]), (vocode, 1)):
            found = []
            flops += times * count_flops(
                lambda: found.extend(attention_calls(model, AttentionBlock, fn)))
            calls += found * times
    return calls, flops


class ServeReference:
    """The reference model on ``device`` with the benchmark's weights, and
    the engine settings of the configuration file's ``engine`` section."""

    def __init__(self, cfg: Config, engine: Dict, weights: Dict[str, torch.Tensor],
                 device):
        self.cfg, self.e = cfg, clamp_buckets(cfg, engine)
        self.device = torch.device(device)
        with torch.device("meta"):
            model = SynthesizerTrn(cfg)
        model = model.to_empty(device=self.device)
        model.load_state_dict(weights)
        self.model = model.float().eval().requires_grad_(False)
        d = cfg.data
        self.frontend = MelFrontend(d.sampling_rate, d.filter_length, d.hop_length,
                                    d.win_length, d.n_mel_channels, d.mel_fmin,
                                    d.mel_fmax, device=self.device)
        steps = self.e["diffusion_steps"]
        sched_cfg = cfg if steps is None else dataclasses.replace(
            cfg, diffusion=dataclasses.replace(cfg.diffusion, infer_steps=steps))
        self.schedule = make_infer_schedule(sched_cfg, device=self.device)
        self.tokenizer = make_tokenizer(d.tokenizer_vocab)

    def text_ids(self, texts: Sequence[str]) -> np.ndarray:
        return text_ids(self.tokenizer, self.e, texts)

    def prompt_mel(self, wav: np.ndarray, width: int) -> torch.Tensor:
        """(width, n_mels) fp32: the wav zero-padded to a 0.5 s grid, its
        log-mel cut to its frames and zero-padded to ``width``."""
        chunk = self.cfg.data.sampling_rate // 2
        w = np.asarray(wav, np.float32)
        frames = prompt_frames(self.cfg, self.e, [w])[0]
        padded = torch.as_tensor(np.pad(w, (0, (-len(w)) % chunk)), device=self.device)
        mel = self.frontend.mel_spectrogram(padded[None])[0, :frames]
        out = torch.zeros((width, mel.shape[1]), device=self.device)
        out[:frames] = mel
        return out

    # ------------------------------------------------------------ the model

    @torch.no_grad()
    def row(self, texts: Sequence[str], wavs: Sequence[np.ndarray], r: int,
            codes: torch.Tensor, key, mel_in: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Row ``r`` of the batch (``texts``, ``wavs``) under the batch's
        ``key``, with the program's served ``codes`` (max_len,) and mel
        ``mel_in`` (frames, n_mels) of that row: text ids, prompt mel, the
        decode's sampler scores at every served position (``z``: penalised,
        tempered logits; ``gumbel``: the step's noise), the GPT latents, the
        diffusion conditioning, the mel, and the wav that the vocoder makes of
        ``mel_in`` (each layer judged on the input that the program gave it,
        as the decode is on the served codes)."""
        cfg, e, dev = self.cfg, self.e, self.device
        n = len(texts)
        ids = self.text_ids(texts)
        frames = prompt_frames(cfg, e, wavs)
        width = bucket_up(max(frames), e["prompt_buckets"])
        refer = self.prompt_mel(wavs[r], width)[None]
        refer_len = torch.tensor([frames[r]], device=dev)
        text = torch.as_tensor(ids[r:r + 1], device=dev)
        g_key, d_key, v_key = prng.split(prng.as_key(key), 3)
        out = {"text": ids[r], "refer_mel": refer[0]}

        max_len = e["max_generate_length"]
        codes = codes.to(dev).long()[None, :max_len]
        gpt = self.model.gpt
        out["z"] = self._decode_scores(refer, refer_len, text, codes)
        v = out["z"].shape[1]
        out["gumbel"] = prng.gumbel_rows(prng.keys_reference(g_key, max_len, True), v,
                                         offset=r * v, device=dev)
        eff = max(max_len - 1, 1)
        bucket = min(bucket_up(eff, e["code_buckets"]), max_len)
        pos = torch.arange(bucket, device=dev)[None]
        codes_b = torch.where(pos < eff, codes[:, :bucket], cfg.gpt.stop_mel_token)
        wav_len = torch.tensor([eff * cfg.gpt.mel_length_compression], device=dev)
        latents = gpt(refer, refer_len, text, codes_b, wav_len)
        out["latents"] = latents[0]

        lb = min(bucket_up(frames[r], e["prompt_buckets"]), width)
        cond = self.model.diffusion_conditioning(refer[:, :lb])
        out["cond"] = cond[0]
        code_emb = self.model.diffusion_code_embedding(latents, cond)
        biases = self.model.diffusion_attention_biases(bucket * FRAMES_PER_CODE)
        shape = (n, bucket * FRAMES_PER_CODE, cfg.diffusion.in_channels)
        rows = Rows(r, r + 1, n)
        n_key, s_key = prng.split(d_key)
        noise = prng.draw(n_key, (1,) + shape[1:], "normal",
                          scale=e["diffusion_temperature"],
                          offset=prng.row_offset(rows, shape), device=dev)

        def model_fn(x2, t2):
            return self.model.diffusion_cfg_step(x2, t2, code_emb, biases)

        k, sampler = cfg.diffusion.cond_free_k, e["diffusion_sampler"]
        if sampler == "ancestral":
            mel = p_sample_loop(self.schedule, model_fn, noise, cond_free_k=k, key=s_key,
                                rows=rows)
        elif sampler == "ddim":
            mel = ddim_sample_loop(self.schedule, model_fn, noise, cond_free_k=k)
        elif sampler == "dpmpp_2m":
            mel = dpmpp_2m_reference_sample_loop(
                model_fn, noise, steps=self.schedule.num_timesteps, guidance_scale=k)
        else:
            mel = dpmpp_2m_sample_loop(self.schedule, model_fn, noise, cond_free_k=k)
        mel = denormalize_mel(mel)
        out["mel"] = mel[0]
        mel = torch.as_tensor(mel_in).to(mel)[None]
        mel_len = torch.tensor([eff * FRAMES_PER_CODE], device=dev)
        m_shape = (n, mel.shape[1], cfg.vaegan.inter_channels)
        noise_v = prng.draw(v_key, (1,) + m_shape[1:], "normal",
                            offset=prng.row_offset(rows, m_shape), device=dev)
        wav = self.model.infer_flowvae(mel, mel_len, e["noise_scale"], noise=noise_v)
        out["wav"] = wav[0, :eff * cfg.gpt.mel_length_compression, 0]
        return out

    def _decode_scores(self, refer, refer_len, text, codes) -> torch.Tensor:
        """(max_len, V) fp32 scores of the decode's steps before their noise,
        teacher-forced on the served codes: step s reads the prefix [cond,
        text, start] and the codes before s; the repetition penalty of the
        codes seen so far (the filler id 1 and the start id first) is
        applied, then the temperature, as a step applies them before its
        nucleus."""
        cfg, gpt, e = self.cfg.gpt, self.model.gpt, self.e
        if e["typical_mass"] < 1.0:
            raise NotImplementedError("the check covers no typical filtering")
        max_len = codes.shape[1]
        prefix = gpt.prefill_embeddings(refer, refer_len, text)
        pos = torch.arange(1, max_len, device=codes.device)[None]
        mel_emb = gpt._mel_embeddings(codes[:, :-1], pos)
        hidden = gpt.gpt(torch.cat([prefix, mel_emb], dim=1))
        logits = gpt._logits(gpt.final_norm(hidden[:, prefix.shape[1] - 1:]))[0].float()
        steps = torch.arange(max_len, device=codes.device)
        # step s has seen the codes served before it: id v from its first step on
        first = torch.full((logits.shape[1],), max_len, dtype=torch.long,
                           device=codes.device).scatter_reduce(0, codes[0], steps, "amin")
        seen = first[None, :] < steps[:, None]
        seen[:, 1] = True
        seen[:, cfg.start_mel_token] = True
        penalty = e["repetition_penalty"]
        if penalty != 1.0:
            div = torch.full((), penalty, device=logits.device)
            pen = torch.where(logits > 0, logits / div, logits * penalty)
            logits = torch.where(seen, pen, logits)
        if e["temperature"] != 1.0:
            logits = logits / torch.full((), e["temperature"], device=logits.device)
        return logits


def nucleus_mass(z: torch.Tensor) -> torch.Tensor:
    """(S, V) fp64: the probability mass, under softmax(z), of the tokens that
    rank above each token in the ascending stable sort of its row.  The
    nucleus of top-p keeps a token whose mass above it is under ``top_p``,
    and the top token always."""
    p = torch.softmax(z.double(), dim=-1)
    _, order = torch.sort(z, dim=-1, stable=True)
    ps = p.gather(-1, order)
    above = ps.flip(-1).cumsum(-1).flip(-1) - ps
    return torch.empty_like(p).scatter_(-1, order, above)


def top_token(z: torch.Tensor) -> torch.Tensor:
    """(S,) the token that ranks first: the last of the ascending stable
    sort (of tied tokens, the one at the largest index)."""
    return torch.sort(z, dim=-1, stable=True)[1][:, -1]


def nucleus(z: torch.Tensor, top_p: float, mass=None) -> torch.Tensor:
    """(S, V) bool: the tokens that top-p keeps."""
    mass = nucleus_mass(z) if mass is None else mass
    kept = mass < top_p
    kept[torch.arange(z.shape[0], device=z.device), top_token(z)] = True
    return kept


def pick(z: torch.Tensor, gumbel: torch.Tensor, top_p: float) -> torch.Tensor:
    """(S,) the token that each step puts first: the largest ``z + gumbel``
    over the nucleus."""
    return (z + gumbel).masked_fill(~nucleus(z, top_p), float("-inf")).argmax(-1)
