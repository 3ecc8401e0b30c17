"""The paper's own experimental configuration (§6 'DyDD set up').

The port's copy of ``repro.configs.cls_paper``, field for field: mesh
size n = 2048, m observations, p = 2..64 subdomains on the 1D reduction
of the paper's domain.  The four validation examples correspond to the
paper's Tables 1-12; ``EXAMPLE4``'s ``ex4_p8`` is the size at which
``chip_smoke.py`` drives the DA paths on the card.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CLSCase:
    name: str
    n: int                 # mesh size (paper: 2048)
    m: int                 # observations
    p: int                 # subdomains / processors
    graph: str             # chain | star
    empty_subdomains: tuple = ()
    distribution: str = "beta"   # non-uniform sparse observations


EXAMPLE1 = (
    CLSCase("ex1_case1", 2048, 1500, 2, "chain"),
    CLSCase("ex1_case2", 2048, 1500, 2, "chain", empty_subdomains=(1,)),
)

EXAMPLE2 = tuple(
    CLSCase(f"ex2_case{k+1}", 2048, 1500, 4, "chain",
            empty_subdomains=tuple(range(k)))
    for k in range(4)
)

EXAMPLE3 = tuple(
    CLSCase(f"ex3_p{p}", 2048, 1032, p, "star") for p in (2, 4, 8, 16, 32)
)

EXAMPLE4 = tuple(
    CLSCase(f"ex4_p{p}", 2048, 2000, p, "chain") for p in (2, 4, 8, 16, 32)
)
