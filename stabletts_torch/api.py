"""High-level inference API (reference: api.py:38-83).

StableTTSAPI(tts_ckpt, vocoder_ckpt, vocoder_name).inference(text, ref_audio,
language, ...) -> (waveform, mel). A vocoder checkpoint is read as the named
vocoder, FireflyGAN ("ffgan", the default) or Vocos ("vocos"); with no path the
vocoder is a random Vocos whatever the name, as in the JAX package. Checkpoints
are reference PyTorch state dicts (FireflyGAN's with its weight norm, folded on
load); with no path the models hold random weights (seeded), which serves smoke
runs.
"""

from __future__ import annotations

import logging
import re
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from stabletts_torch.config import MelConfig, ModelConfig, VocosConfig
from stabletts_torch.models import build_stabletts
from stabletts_torch.models.ffgan import FireflyGANBase
from stabletts_torch.models.sampler import prepare, sample, synthesise
from stabletts_torch.models.vocos import Vocos
from stabletts_torch.ops.stft import log_mel_spectrogram
from stabletts_torch.text import cleaned_text_to_sequence, intersperse
from stabletts_torch.text.english import english_to_ipa2
from stabletts_torch.text.japanese import japanese_to_ipa2
from stabletts_torch.text.mandarin import chinese_to_cnm3
from stabletts_torch.text.router import auto_g2p
from stabletts_torch.utils.convert import load_ffgan_state_dict, load_torch_state_dict
from stabletts_torch.utils.device import resolve_device
from stabletts_torch.utils.metrics import count, span

logger = logging.getLogger("stabletts_torch.api")


def get_vocoder(model_path: str, model_name: str = "ffgan", device=None,
                vocos_config: Optional[VocosConfig] = None, mel_config: Optional[MelConfig] = None):
    """The named vocoder, FireflyGAN ("ffgan") or Vocos ("vocos"), loaded from
    a reference PyTorch state dict and returned on `device` (the GPU unless
    the caller passes "cpu") in eval mode (reference: api.py:19-36; the JAX
    package's `get_vocoder` returns the module with its variables). Vocos is
    built at `vocos_config` / `mel_config`, the defaults unless given."""
    if model_name == "ffgan":
        model = FireflyGANBase(device="cpu")
        model.load_state_dict(load_ffgan_state_dict(load_torch_state_dict(model_path)))
    elif model_name == "vocos":
        model = Vocos(vocos_config or VocosConfig(), mel_config or MelConfig(), device="cpu")
        model.load_state_dict(load_torch_state_dict(model_path))
    else:
        raise NotImplementedError(f"Unsupported vocoder: {model_name}")
    return model.to(resolve_device(device)).eval()


class StableTTSAPI:
    # serving shape ladder: text padded to 64-id buckets, reference mels to
    # 512-frame buckets; masks keep the computation exact on the padding
    _TEXT_BUCKET = 64
    _REF_BUCKET = 512

    def __init__(
        self,
        tts_model_path: Optional[str] = None,
        vocoder_model_path: Optional[str] = None,
        vocoder_name: str = "ffgan",
        model_config: Optional[ModelConfig] = None,
        mel_config: Optional[MelConfig] = None,
        vocos_config: Optional[VocosConfig] = None,
        max_mel_len: int = 1024,
        warmup_lengths: Optional[Sequence[int]] = None,
        device=None,
    ):
        """Runs on `device`: the GPU unless the caller passes "cpu".
        warmup_lengths, e.g. (1024, 2048), turns on the shape ladder and runs
        each mel cap once up front."""
        if vocoder_name not in ("vocos", "ffgan"):
            raise ValueError(f"vocoder {vocoder_name!r} is not one of 'vocos', 'ffgan'")
        self.device = resolve_device(device)
        self.mel_config = mel_config or MelConfig()
        self.tts_model_config = model_config or ModelConfig()
        self._vocos_config = vocos_config or VocosConfig()
        self._default_max_mel_len = max_mel_len

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            self.tts_model = build_stabletts(self.tts_model_config, self.mel_config, device="cpu")
            torch.manual_seed(1)
            # the named vocoder only from a checkpoint; else a random Vocos
            if vocoder_model_path is None:
                self.vocoder_model = Vocos(self._vocos_config, self.mel_config, device="cpu")
            else:
                self.vocoder_model = get_vocoder(vocoder_model_path, vocoder_name, "cpu", self._vocos_config,
                                                 self.mel_config)
        # both vocoders take per-item lengths (the fixed-shape serving mode);
        # a request vocodes its whole cap with them only through Vocos, and
        # trims the mel for FireflyGAN, whose work a frame is 25 times Vocos's
        self._vocode_request_at_cap = isinstance(self.vocoder_model, Vocos)
        if tts_model_path is not None:
            self.tts_model.load_state_dict(load_torch_state_dict(tts_model_path))
        self.tts_model.to(self.device)
        self.vocoder_model.to(self.device)

        self.g2p_mapping = {
            "chinese": chinese_to_cnm3,
            "japanese": japanese_to_ipa2,
            "english": english_to_ipa2,
            # mixed-language routing by script (text/router.py)
            "auto": auto_g2p,
        }
        self.supported_languages = self.g2p_mapping.keys()
        self._shape_ladder = warmup_lengths is not None
        if warmup_lengths:
            self.warmup(tuple(warmup_lengths))

    @staticmethod
    def _round_up(n: int, m: int) -> int:
        return max(m, -(-n // m) * m)

    def _phonemes(self, text: str, language: str) -> list:
        phonemizer = self.g2p_mapping.get(language)
        if phonemizer is None:
            raise ValueError(f"language {language!r} not in {list(self.supported_languages)}")
        with span("api.g2p"):
            return intersperse(cleaned_text_to_sequence(phonemizer(text)), 0)

    def _reference_mel(self, ref_audio) -> tuple:
        """numpy waveform, or the path of a WAV, FLAC, mp3 or ogg file
        (resampled to the mel config's rate) -> ([1, Tref, n_mels] mel, mask or None), bucketed in
        ladder mode."""
        with span("api.ref_mel"):
            if isinstance(ref_audio, str):
                from stabletts_torch.utils.audio_io import load_and_resample_audio

                ref_audio = load_and_resample_audio(ref_audio, self.mel_config.sample_rate)
                if ref_audio is None:
                    raise ValueError("could not load the reference audio file (WAV, FLAC, mp3 and ogg are decodable)")
            wav = torch.from_numpy(np.asarray(ref_audio, dtype=np.float32)).to(self.device)
            ref_mel = log_mel_spectrogram(wav[None, :], self.mel_config)
            if not self._shape_ladder:
                return ref_mel, None
            t = ref_mel.shape[1]
            t_pad = self._round_up(t, self._REF_BUCKET)
            ref_mel = torch.nn.functional.pad(ref_mel, (0, 0, 0, t_pad - t))
            mask = (torch.arange(t_pad, device=self.device)[None, :] < t).float()
            return ref_mel, mask

    def _noise(self, b: int, cap: int, seed: int) -> torch.Tensor:
        gen = torch.Generator().manual_seed(seed)
        return torch.randn((b, cap, self.mel_config.n_mels), generator=gen).to(self.device)

    def _synthesise_regrow(self, x, x_lengths, ref_mel, ref_mask, max_mel_len, seed, length_scale,
                           **kw) -> tuple:
        """synthesise at the mel cap doubled (up to 8192) until it holds every
        item's predicted length. The lengths come from `prepare`, before the
        flow, so the flow runs once, at the final cap with the noise drawn
        there. Returns synthesise's dict and the lengths on the host."""
        with span("api.synthesise"):
            while True:
                prep = prepare(self.tts_model, x, x_lengths, ref_mel, max_mel_len, length_scale,
                               y_ref_mask=ref_mask, device=self.device)
                # drawn on the host while the device runs prepare
                noise = self._noise(x.shape[0], max_mel_len, seed)
                # prepare has finished (the noise's copy waited for it): read what the cap and the trimming
                # need, so the request waits on the device again only at its copy back
                lengths, clamped = prep["y_lengths"].cpu(), prep["y_clamped"].cpu()
                if max_mel_len >= 8192 or not bool(clamped.any()):
                    return sample(self.tts_model, prep, noise, device=self.device, **kw), lengths
                max_mel_len *= 2
                logger.warning("predicted length exceeded the mel cap; regrowing to %d", max_mel_len)

    def _vocode(self, mel: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """The whole padded mel through the vocoder with the per-item lengths:
        each item as its trimmed mel vocoded alone, zero past its length."""
        with span("api.vocode"):
            return self.vocoder_model(mel, lengths)

    def warmup(self, lengths: Sequence[int] = (1024, 2048), text_buckets: Sequence[int] = (64, 128),
               ref_buckets: Sequence[int] = (512,), step: int = 10, solver: str = "euler",
               cfg: float = 3.0) -> float:
        """Runs the pipeline once at every ladder shape (kernel build, cuDNN
        plans, allocator pools), then the estimator once at every length a
        request's flow may run at: its length plus one frame rounded up to
        the model's `frame_quantum` (`models/sampler.py`: `length_groups`),
        up to the largest cap. Returns wall seconds."""
        self._shape_ladder = True
        t0 = time.time()
        for tref in ref_buckets:
            ref_mel = torch.zeros((1, tref, self.mel_config.n_mels), device=self.device)
            ref_mask = torch.ones((1, tref), device=self.device)
            for tx in text_buckets:
                x = torch.zeros((1, tx), dtype=torch.long, device=self.device)
                x_lengths = torch.tensor([min(8, tx)], device=self.device)
                for cap in lengths:
                    out = synthesise(
                        self.tts_model, x, x_lengths, torch.zeros((1, cap, self.mel_config.n_mels)),
                        ref_mel, n_timesteps=step, solver=solver, cfg=cfg, max_mel_len=cap,
                        y_ref_mask=ref_mask, device=self.device,
                    )
                    self._vocode(out["decoder_outputs"], out["y_lengths"])
        model, row = self.tts_model, torch.zeros(1, dtype=torch.long, device=self.device)
        with torch.no_grad():
            cond = model.flow_condition(prepare(model, x, x_lengths, ref_mel, max(lengths), y_ref_mask=ref_mask,
                                                device=self.device), cfg)
            t = torch.tensor(0.5, device=self.device)
            for frames in range(model.frame_quantum, cond["y_mask"].shape[1] + 1, model.frame_quantum):
                xt = torch.zeros((1, frames, self.mel_config.n_mels), device=self.device)
                model.flow_velocity(model.flow_rows(cond, row, frames), t, xt, cfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time() - t0

    def inference(self, text: str, ref_audio, language: str, step: int = 10, temperature: float = 1.0,
                  length_scale: float = 1.0, solver: str = "euler", cfg: float = 3.0,
                  max_mel_len: Optional[int] = None, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """text + reference waveform -> (waveform [1, T_wav], mel [1, n_mels, T])."""
        with span("api.request", new_unit=True):
            count("api.requests")
            max_mel_len = max_mel_len or self._default_max_mel_len
            ids = self._phonemes(text, language)
            true_len = len(ids)
            if self._shape_ladder:
                ids = ids + [0] * (self._round_up(true_len, self._TEXT_BUCKET) - true_len)
            x = torch.tensor([ids], dtype=torch.long, device=self.device)
            x_lengths = torch.tensor([true_len], device=self.device)
            ref_mel, ref_mask = self._reference_mel(ref_audio)
            out, lengths = self._synthesise_regrow(
                x, x_lengths, ref_mel, ref_mask, max_mel_len, seed, n_timesteps=step,
                temperature=temperature, length_scale=length_scale, solver=solver, cfg=cfg,
            )
            y_len = int(lengths[0])
            with span("api.vocode"):
                if self._shape_ladder and self._vocode_request_at_cap:
                    # fixed shape: the full cap with a length mask (exact, see Vocos)
                    audio = self.vocoder_model(out["decoder_outputs"], out["y_lengths"])
                    audio = audio[:, : y_len * self.mel_config.hop_length]
                else:
                    audio = self.vocoder_model(out["decoder_outputs"][:, :y_len])
            mel = out["decoder_outputs"][:, :y_len]
            with span("api.to_host"):
                return audio.cpu().numpy(), mel.cpu().numpy().transpose(0, 2, 1)

    def batch_inference(self, items: list, ref_audio, step: int = 10, temperature: float = 1.0,
                        length_scale: float = 1.0, solver: str = "euler", cfg: float = 3.0,
                        max_mel_len: Optional[int] = None, seed: int = 0) -> list:
        """items: (text, language) pairs sharing one reference voice, run as
        one batch. Returns a list of waveforms trimmed to each item's length."""
        with span("api.request", new_unit=True):
            count("api.requests")
            max_mel_len = max_mel_len or self._default_max_mel_len
            id_lists = [self._phonemes(text, language) for text, language in items]
            b = len(id_lists)
            tx = max(len(ids) for ids in id_lists)
            if self._shape_ladder:
                tx = self._round_up(tx, self._TEXT_BUCKET)
            x = np.zeros((b, tx), dtype=np.int64)
            for i, ids in enumerate(id_lists):
                x[i, : len(ids)] = ids
            x_lengths = torch.tensor([len(ids) for ids in id_lists], device=self.device)
            ref_mel, ref_mask = self._reference_mel(ref_audio)
            ref_mel = ref_mel.expand(b, -1, -1)
            if ref_mask is not None:
                ref_mask = ref_mask.expand(b, -1)
            out, lengths = self._synthesise_regrow(
                torch.from_numpy(x).to(self.device), x_lengths, ref_mel, ref_mask, max_mel_len, seed,
                n_timesteps=step, temperature=temperature, length_scale=length_scale, solver=solver, cfg=cfg,
            )
            audio = self._vocode(out["decoder_outputs"], out["y_lengths"])
            with span("api.to_host"):
                audio = audio.cpu().numpy()
            hop = self.mel_config.hop_length
            return [audio[i, : int(lengths[i]) * hop] for i in range(b)]

    _SENT_SPLIT = re.compile(r"(?<=[.!?;。！？；…])\s*")
    _CLAUSE_SPLIT = re.compile(r"(?<=[,:、，：])\s*")

    @classmethod
    def _split_sentences(cls, text: str, max_chars: int) -> list:
        """Sentence-split `text`, then greedily merge tiny sentences and
        clause-split (then hard-split) any single piece over max_chars."""
        pieces = [s for s in cls._SENT_SPLIT.split(text.strip()) if s.strip()]
        atomic: list = []
        for s in pieces:
            if len(s) <= max_chars:
                atomic.append(s)
                continue
            for c in (c for c in cls._CLAUSE_SPLIT.split(s) if c.strip()):
                while len(c) > max_chars:  # unpunctuated runs
                    cut = c.rfind(" ", 0, max_chars)
                    cut = cut if cut > max_chars // 2 else max_chars
                    atomic.append(c[:cut])
                    c = c[cut:].lstrip()
                if c:
                    atomic.append(c)
        chunks: list = []
        for s in atomic:
            if chunks and len(chunks[-1]) + len(s) + 1 <= max_chars:
                sep = "" if not chunks[-1][-1:].isascii() else " "
                chunks[-1] = chunks[-1] + sep + s
            else:
                chunks.append(s)
        return chunks

    def inference_long(self, text: str, ref_audio, language: str, step: int = 10,
                       temperature: float = 1.0, length_scale: float = 1.0, solver: str = "euler",
                       cfg: float = 3.0, max_mel_len: Optional[int] = None, seed: int = 0,
                       max_chars_per_chunk: Optional[int] = None,
                       crossfade_ms: float = 40.0) -> Tuple[np.ndarray, np.ndarray]:
        """Arbitrary-length text -> (waveform [1, T_wav], mel [1, n_mels, T]):
        sentence chunks synthesised as one batch with the same voice, joined
        with an equal-power crossfade."""
        if max_chars_per_chunk is None:
            max_chars_per_chunk = 300 if language == "english" else 100
        chunks = self._split_sentences(text, max_chars_per_chunk)
        if not chunks:
            raise ValueError("no synthesizable text after splitting")
        kw = dict(step=step, temperature=temperature, length_scale=length_scale, solver=solver,
                  cfg=cfg, max_mel_len=max_mel_len, seed=seed)
        if len(chunks) == 1:
            return self.inference(chunks[0], ref_audio, language, **kw)
        wavs = self.batch_inference([(c, language) for c in chunks], ref_audio, **kw)
        xfade = int(self.mel_config.sample_rate * crossfade_ms / 1000.0)
        out = wavs[0].astype(np.float32)
        for w in wavs[1:]:
            w = w.astype(np.float32)
            n = min(xfade, len(out), len(w))
            if n > 0:
                t = np.linspace(0.0, np.pi / 2, n, dtype=np.float32)
                out = np.concatenate([out[:-n], out[-n:] * np.cos(t) ** 2 + w[:n] * np.sin(t) ** 2, w[n:]])
            else:
                out = np.concatenate([out, w])
        # the mel of the joined waveform (per-chunk mels do not survive the crossfade)
        mel = log_mel_spectrogram(torch.from_numpy(out)[None, :].to(self.device), self.mel_config)
        return out[None, :], mel.cpu().numpy().transpose(0, 2, 1)

    def get_params(self) -> Tuple[float, float]:
        """(tts_params_M, vocoder_params_M)."""
        count = lambda m: sum(p.numel() for p in m.parameters())
        return count(self.tts_model) / 1e6, count(self.vocoder_model) / 1e6
