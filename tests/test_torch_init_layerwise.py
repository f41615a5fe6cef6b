"""`Model.init` draws each stacked leaf one layer at a time, so a bf16
init never holds an fp32 copy of a whole stack (qwen3-moe-30b-a3b's
experts are 38.7 GB in fp32) and is the fp32 init rounded, leaf for leaf
and bit for bit; `launch.serve` inits straight in bf16. Held at the smoke
configs of the two archs whose fp32 trees do not fit one card:
qwen3-moe-30b-a3b and chameleon-34b."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "chameleon-34b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_init_is_the_fp32_init_rounded(arch):
    model = build_model(dataclasses.replace(smoke_config(arch),
                                            vocab_size=64))
    full = tree_leaves(model.init(seed=5, device="cpu"))
    half = tree_leaves(model.init(seed=5, dtype=torch.bfloat16,
                                  device="cpu"))
    for s, f, h in zip(tree_leaves(model.spec), full, half, strict=True):
        assert f.dtype == torch.float32 and h.dtype == torch.bfloat16
        assert torch.equal(h, f.to(torch.bfloat16)), s


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_leaves_are_drawn_one_layer_at_a_time(arch, monkeypatch):
    """No fp32 draw is larger than one layer of a stacked leaf or one
    unstacked leaf."""
    model = build_model(dataclasses.replace(smoke_config(arch),
                                            vocab_size=64))
    drawn = []
    trunc = P._trunc_normal

    def record(shape, gen):
        drawn.append(tuple(shape))
        return trunc(shape, gen)
    monkeypatch.setattr(P, "_trunc_normal", record)
    model.init(seed=0, dtype=torch.bfloat16, device="cpu")
    want = []
    for s in tree_leaves(model.spec):
        if s.init not in ("normal", "embed"):
            continue
        if s.axes[:1] == ("layers",):
            want += [s.shape[1:]] * s.shape[0]
        else:
            want.append(s.shape)
    assert drawn == want
    stacked = [s for s in tree_leaves(model.spec) if s.axes[:1] == ("layers",)]
    assert max(math.prod(d) for d in drawn) < \
        max(math.prod(s.shape) for s in stacked)


def test_the_launcher_inits_in_bf16(capsys):
    report = serve.main(["--arch", "qwen3-moe-30b-a3b", "--requests", "2",
                         "--num-slots", "2", "--prompt-len", "8",
                         "--max-new", "2", "--capacity", "16",
                         "--device", "cpu"])
    assert report["init_s"] > 0 and len(report["outputs"]) == 2
    assert "parameters in bf16" in capsys.readouterr().out
