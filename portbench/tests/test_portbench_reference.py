"""The plain reference (portbench/ref, a frozen copy of the port's
model on plain formulations) against the port's own plain path, and the
weights made from the seed."""
import dataclasses
import math

import torch

from hotformerloc_torch.models.config import tiny_test_config
from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
from portbench.core import reference
from portbench.core.weights import load_weights, make_weights
from portbench.ref.ops.precision import fp8_products, product


def fields():
    return dataclasses.asdict(tiny_test_config(num_points=256))


def test_weights_same_seed_same_weights():
    a = make_weights(fields(), 2 ** 31 + 5, "cpu")
    b = make_weights(fields(), 2 ** 31 + 5, "cpu")
    c = make_weights(fields(), 2 ** 31 + 6, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_weights_follow_the_initialisers():
    w = make_weights(fields(), 3, "cpu")
    m = HOTFormerLoc(tiny_test_config(num_points=256), device="cpu")
    for n, p in m.named_parameters():
        kind, t = p.init_kind, w[n]
        assert t.shape == p.shape
        if kind[0] == "const":
            assert torch.all(t == kind[1])
        elif kind[0] == "trunc":
            assert t.abs().max() <= 2 * kind[1] + 1e-7
        elif kind[0] == "fan_in" and t.numel() > 1000:
            want = math.sqrt(kind[1] if len(kind) > 1 else 1.0) \
                / math.sqrt(math.prod(p.shape[:-1]))
            assert abs(float(t.std()) / want - 1) < 0.1


def test_reference_forward_matches_the_port_plain_path():
    w = make_weights(fields(), 11, "cpu")
    m = HOTFormerLoc(tiny_test_config(num_points=256), device="cpu")
    load_weights(m, w)
    m.set_use_kernels(False)
    g = torch.Generator().manual_seed(1)
    pts = torch.rand((5, 256, 3), generator=g) * 1.8 - 0.9
    with torch.no_grad():
        want = m(pts, torch.ones(5, 256, dtype=torch.bool))["global"]
    ref = reference.build(fields(), w, "cpu")
    got, ovf = reference.embed(ref, pts, chunk=2)
    assert ovf == 0
    assert float((got - want).abs().max()) < 1e-5


def test_fp8_products_round_forward_operands_only():
    x = torch.linspace(-3, 3, 1001, requires_grad=True)
    with fp8_products():
        q = product(x)
    err = (q - x).detach().abs()
    assert float(err.max()) > 0                         # 3 mantissa bits:
    assert torch.all(err <= x.detach().abs() / 16 + 1e-6)   # half a step
    assert len(torch.unique(q.detach())) < 300
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))   # straight through
    assert product(x) is x
