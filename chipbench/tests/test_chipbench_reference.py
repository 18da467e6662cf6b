"""The plain reference against the program's plain path (the CPU's: the
plain attention and the plain sequential scan), both in float32 on the
same raw weights, at smoke size: a prefill and decode steps through the
cache against the reference's one forward pass. The program computes
Mamba-1's mixer, so the mamba block is held to it without FalconMamba's
mixer norms; with them, the reference is held to the published model's
own code (Hugging Face ``FalconMambaForCausalLM``)."""
import dataclasses

import numpy as np
import pytest
import torch

from chipbench import port, weights
from chipbench.reference import mamba, precision
from chipbench.reference.model import Reference
from chipbench.tests import smoke

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["qwen2-72b", "falcon-mamba-7b"])
def test_reference_matches_the_programs_plain_path(name):
    from repro_torch.models import Model

    c = smoke.config(name)
    c.pop("mixer_rms_eps", None)          # Mamba-1's mixer, the program's
    served = Model(port.arch_config(c))
    raw = weights.make(c, 11, CPU)
    params = port.params(served, c, raw)
    model = Model(dataclasses.replace(served.cfg, compute_dtype="float32"))
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, c["vocab_size"], (2, 24)))
    P = 16
    with torch.inference_mode():
        logits, cache = model.prefill(params, toks[:, :P], max_len=24)
        got = [logits]
        for i in range(P, 24):
            pos = torch.full((2,), i, dtype=torch.int32)
            logits, cache = model.decode_step(params, toks[:, i:i + 1], pos, cache)
            got.append(logits)
        got = torch.stack(got[:-1], 1)                      # positions P-1 .. 22
        with precision.exact():
            ref = Reference(c, raw)
            want = ref.logits(ref.hidden(toks)[:, P - 1:-1])
    assert got.shape == want.shape
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 2e-5, err


def test_mamba_reference_is_the_published_falcon_mamba(monkeypatch):
    for flag in ("USE_TF", "USE_FLAX", "USE_JAX"):   # its PyTorch side alone
        monkeypatch.setenv(flag, "0")
    transformers = pytest.importorskip("transformers")
    c = smoke.config("falcon-mamba-7b")
    d = mamba.dims(c)
    raw = weights.make(c, 12, CPU)
    hf = transformers.FalconMambaForCausalLM(transformers.FalconMambaConfig(
        vocab_size=c["vocab_size"], hidden_size=d["M"], state_size=d["N"],
        num_hidden_layers=c["num_hidden_layers"], layer_norm_epsilon=c["layer_norm_epsilon"],
        expand=c["expand"], conv_kernel=d["K"], use_bias=c["use_bias"],
        use_conv_bias=c["use_conv_bias"], time_step_rank=d["R"],
        mixer_rms_eps=c["mixer_rms_eps"], residual_in_fp32=c["residual_in_fp32"],
        tie_word_embeddings=False)).float().eval()
    lw, mw = raw["layers"]["mamba"], raw["model"]
    state = {"backbone.embeddings.weight": mw["embed_tokens"],
             "backbone.norm_f.weight": mw["norm"], "lm_head.weight": mw["lm_head"].T}
    for i in range(c["num_hidden_layers"]):
        p = f"backbone.layers.{i}."
        state.update({
            p + "norm.weight": lw["norm"][i],
            p + "mixer.in_proj.weight": lw["in_proj"][i].T,
            p + "mixer.conv1d.weight": lw["conv_w"][i].T[:, None, :],
            p + "mixer.conv1d.bias": lw["conv_b"][i],
            p + "mixer.x_proj.weight": lw["x_proj"][i].T,
            p + "mixer.dt_proj.weight": lw["dt_proj"][i].T,
            p + "mixer.dt_proj.bias": lw["dt_bias"][i],
            p + "mixer.A_log": lw["A_log"][i], p + "mixer.D": lw["D"][i],
            p + "mixer.out_proj.weight": lw["out_proj"][i].T})
    hf.load_state_dict({k: v.float().contiguous() for k, v in state.items()})
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, c["vocab_size"], (2, 24)))
    with torch.inference_mode(), precision.exact():
        want = hf(toks).logits
        ref = Reference(c, raw)
        got = ref.logits(ref.hidden(toks))
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 2e-5, err


@pytest.mark.parametrize("T", [1, 2, 7, 64])
def test_parallel_recurrence_equals_the_loop(T):
    g = torch.Generator().manual_seed(T)
    a = torch.rand((T, 3, 5), generator=g, dtype=torch.float64)
    b = torch.randn((T, 3, 5), generator=g, dtype=torch.float64)
    h, want = torch.zeros(3, 5, dtype=torch.float64), []
    for t in range(T):
        h = a[t] * h + b[t]
        want.append(h)
    torch.testing.assert_close(mamba.linear_recurrence(a, b), torch.stack(want),
                               rtol=1e-12, atol=1e-12)


def test_fp8_control_rounds_to_e4m3_with_scales():
    x = torch.tensor([[1.0, -3.0, 448.0 * 2], [0.5, 0.25, 0.0]])
    q = precision.fake_fp8(x, -1)
    assert q[0, 2] == x[0, 2] and q[1, 0] == x[1, 0]   # each row's amax is exact
    assert torch.allclose(q, x, rtol=2 ** -3)
    assert not torch.equal(precision.FP8().weight(torch.randn(64, 64)),
                           precision.Exact().weight(torch.randn(64, 64)))


def test_exact_turns_tf32_off_and_puts_it_back():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with precision.exact():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
