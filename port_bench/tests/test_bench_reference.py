"""Each plain reference against ``repro_torch`` on the CPU."""
from __future__ import annotations

import contextlib
import dataclasses
import io

import pytest
import torch

from port_bench import bench, generate
from port_bench.reference import cp_als as ref_als
from port_bench.reference.precision import tf32
from port_bench.reference.spttn import contract

SPECS = {
    "mttkrp": ("ijk,ja,ka->ia", ["T", "B", "C"], (30, 20, 25), {"a": 6}),
    "ttmc3": ("ijk,jr,ks->irs", ["T", "U", "V"], (30, 20, 25),
              {"r": 3, "s": 4}),
    "ttmc4": ("ijkl,jr,ks,lt->irst", ["T", "U", "V", "W"], (12, 10, 14, 5),
              {"r": 2, "s": 3, "t": 4}),
}


def _inputs(expr, names, shape, ranks, nnz=1500, seed=3):
    from repro_torch import COOTensor, build_csf
    coo = generate.frostt_like({"shape": list(shape), "nnz": nnz, "recipe": {
        "lead_exponent": 0.8, "draws_per_nnz": 2}}, seed, "cpu")
    ins = expr.split("->")[0].split(",")
    dims = {**dict(zip(ins[0], shape)), **ranks}
    g = torch.Generator().manual_seed(seed)
    factors = {n: torch.randn([dims[c] for c in ind], generator=g)
               for ind, n in zip(ins[1:], names[1:])}
    host = COOTensor(coords=coo.coords.to(torch.int32).numpy(),
                     values=coo.values.numpy(), shape=tuple(shape))
    return coo, factors, build_csf(host), dims


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("fused", [False, True])
def test_contract_matches_the_port(name, fused):
    from repro_torch import execute_plan, parse, plan
    expr, names, shape, ranks = SPECS[name]
    coo, factors, csf, dims = _inputs(expr, names, shape, ranks)
    spec = parse(expr, dims=dims, sparse=0, names=names)
    p = plan(spec, nnz_levels=csf.nnz_levels())
    if fused:
        p = dataclasses.replace(p, backend="cuda", fused=True, block=8)
    got = execute_plan(p, csf, factors, device="cpu")
    want = contract(expr, names, coo.coords, coo.values, coo.shape, factors)
    assert want.dtype == torch.float64
    assert bench.rel_err(got, want) < 1e-5


def test_contract_takes_factors_in_any_index_order():
    expr, names, shape, ranks = SPECS["mttkrp"]
    coo, factors, _, _ = _inputs(expr, names, shape, ranks)
    flipped = {"B": factors["B"].T.contiguous(), "C": factors["C"]}
    a = contract(expr, names, coo.coords, coo.values, coo.shape, factors)
    b = contract("ijk,aj,ka->ia", names, coo.coords, coo.values, coo.shape,
                 flipped)
    assert torch.allclose(a, b)


def test_contract_blocks_agree(monkeypatch):
    from port_bench.reference import spttn
    expr, names, shape, ranks = SPECS["ttmc4"]
    coo, factors, _, _ = _inputs(expr, names, shape, ranks)
    whole = contract(expr, names, coo.coords, coo.values, coo.shape, factors)
    monkeypatch.setattr(spttn, "BLOCK_BYTES", 8 * 24 * 4 * 7)
    assert torch.allclose(whole, contract(expr, names, coo.coords,
                                          coo.values, coo.shape, factors))


def test_tf32_rounds_to_ten_mantissa_bits():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one, one + ulp / 2, one + 3 * ulp / 2,
                      one + ulp / 2 + 2.0 ** -20, -(one + ulp)])
    assert tf32(x).tolist() == [one, one, one + 2 * ulp, one + ulp,
                                -(one + ulp)]


def test_cp_als_reference_matches_the_port():
    """Over a dozen sweeps at a small size the factors agree with the
    port's; the TF32 reference's are far off."""
    from repro_torch import COOTensor
    from repro_torch.examples.cp_als import cp_als
    coo = generate.frostt_like({"shape": [60, 40, 50], "nnz": 8000,
                                "recipe": {"lead_exponent": 0.8,
                                           "draws_per_nnz": 2}}, 9, "cpu")
    host = COOTensor(coords=coo.coords.to(torch.int32).numpy(),
                     values=coo.values.numpy(), shape=coo.shape)
    with contextlib.redirect_stdout(io.StringIO()):
        got, _ = cp_als(host, rank=4, steps=12, seed=2**31 + 3,
                        device="cpu")
    args = (coo.coords, coo.values, coo.shape, 4, 12, 2**31 + 3)
    want = ref_als.als(*args)
    gap = max(bench.rel_err(g, w) for g, w in zip(got, want))
    assert gap < 1e-5
    tf32 = ref_als.als(*args, precision="tf32")
    assert max(bench.rel_err(g, w) for g, w in zip(tf32, want)) > 30 * gap
