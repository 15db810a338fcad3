"""Faults planted in the program underneath a run, for the tests and for
reading a fault's numbers on the card (`control.py --fault`). Each takes a
`setattr`-like function (pytest's monkeypatch.setattr, or plain setattr)."""

import torch


def vocoder_output(patch):
    """The waveform altered where the vocoder produces it."""
    from stabletts_torch.models import vocos

    orig = vocos.Vocos.forward
    patch(vocos.Vocos, "forward", lambda self, mel, lengths=None: orig(self, mel, lengths) * 1.2)


def sampler_output(patch):
    """The mel altered where the sampler's ODE produces it."""
    from stabletts_torch.models import sampler

    orig = sampler.odeint
    patch(sampler, "odeint", lambda *a, **k: orig(*a, **k) * 0.8)


def durations(patch):
    """Every phoneme 30% longer where the durations are made."""
    from stabletts_torch.models import stabletts

    orig = stabletts.StableTTS.prepare_synthesis

    def prep(self, x, x_lengths, y_ref, max_mel_len, length_scale=1.0, *a, **k):
        return orig(self, x, x_lengths, y_ref, max_mel_len, length_scale * 1.3, *a, **k)

    patch(stabletts.StableTTS, "prepare_synthesis", prep)


def state_unchanged(patch):
    """The program's optimizer steps without changing anything."""
    from stabletts_torch.train import train_tts

    class Frozen(torch.optim.AdamW):
        def step(self, closure=None):
            return None

    patch(train_tts, "make_optimizer",
          lambda model, cfg: Frozen(model.parameters(), lr=cfg.learning_rate, weight_decay=0.01))


def half_batch(patch):
    """Half of each batch left out, the mean taken over the rest."""
    from stabletts_torch.train import train_tts

    orig = train_tts.model_losses

    def half(model, batch, gen, *a, **k):
        b = batch[0].shape[0] // 2
        return orig(model, tuple(t[:b] for t in batch), gen, *a, **k)

    patch(train_tts, "model_losses", half)


def loss_altered(patch):
    """The diffusion loss altered by 5% where the model produces it."""
    from stabletts_torch.models import stabletts

    orig = stabletts.StableTTS.forward

    def fwd(self, *a, **k):
        dur, diff, prior, attn = orig(self, *a, **k)
        return dur, diff * 1.05, prior, attn

    patch(stabletts.StableTTS, "forward", fwd)


SERVING = {"wave": vocoder_output, "mel": sampler_output, "duration": durations}
TRAINING = {"state_unchanged": state_unchanged, "half_batch": half_batch, "loss_altered": loss_altered}
