"""NttConfig: the trace-time configuration record.

The reference's configuration system is C++ template parameters -- modulus,
modmul engine, radix per stage, blocking, transpose strategy -- all fixed at
compile time (SURVEY.md section 6, "Config / flag system").  The JAX
equivalent is this dataclass: every field is static at jit-trace time, so XLA
specializes exactly like the C++ compiler did.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..field.modulus import Modulus


def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


@dataclass(frozen=True)
class NttConfig:
    """Static plan for one transform length over one prime field.

    Strategies (the reference's kernel/algorithm families, README.md:7-8):

    * ``iterative``  -- all stages over the full vector (reference
      kernel/iterative.hpp); right for short lengths.
    * ``six_step``   -- n = n0*n1 matrix: column NTTs, twiddle, transpose,
      row NTTs, transpose (reference layer/sve/generic.hpp four/six-step).
      On one device the row step runs in place along the matrix's second
      axis (no transposes); on a mesh the transposes are all-to-alls.

    ``engine`` selects the leaf implementation: ``jnp`` (radix-2
    butterflies on u32 limb pairs), ``mxu`` (the length-m DFT as int8
    matrix products, ops/ntt_mxu.py) or ``auto`` (a rule on n alone,
    plan/wrapper.py ``_resolve_engine``).

    ``max_fused``, ``chunk_elems`` and ``split_w_only`` default to static
    heuristics; ``tune=True`` replaces them with values selected by the
    benchmark-driven autotuner (plan/autotune.py) -- the analogue of the
    reference choosing every template parameter from its measured tuning
    corpus (reference tests/bench-transpose.cpp:105-499, README.md:26-27).
    """

    modulus: int
    generator: int
    n: int
    strategy: str = "auto"  # "iterative" | "six_step" | "auto"
    n0: int | None = None  # six-step: column-transform length (matrix rows)
    n1: int | None = None  # six-step: row-transform length (matrix cols)
    lazy: bool | None = None  # None: lazy iff bit_width(N) <= 62
    engine: str = "auto"  # "jnp" | "mxu" | "auto"
    #: Twiddle-multiply engine (reference's PAdic64 vs FixedPoint64 choice):
    #: "montgomery", "shoup" (needs bit_width(N) <= 62), "solinas"
    #: (sparse-high moduli), or "auto" (plan/wrapper.py _resolve_modmul).
    modmul: str = "auto"
    max_fused: int | None = None  # largest leaf in the plan tree
    #: jnp engine: chunk size in elements of a leaf level (None = the
    #: static default, plan/planner.py JNP_RESIDENT_ELEMS).
    chunk_elems: int | None = None
    #: Store the inter-step twiddle matrix WITHOUT its Montgomery companion
    #: array (the multiply recomputes the companion in flight) -- halves the
    #: table read of large six-step levels at the cost of one extra u64
    #: low-product per point.  None = size heuristic
    #: (plan/planner.py W_ONLY_THRESHOLD); the analogue of the reference's
    #: store_precomputation=false memory/compute trade
    #: (reference layer/sve/radix-two.hpp:96-138).
    split_w_only: bool | None = None
    #: Explicit MIXED-ENGINE plan tree, overriding strategy/engine/
    #: max_fused plan construction: a comma list, top-down -- every
    #: element but the last is ``engine:m1`` (one Split level whose ROW
    #: leaf uses that engine at length m1), the last is a bare engine
    #: name for the final column leaf.  E.g. ``"mxu:512,mxu:512,jnp"``
    #: at n = 2^26 = Split(2^26, 2^17, 512-mxu) -> Split(2^17, 2^8,
    #: 512-mxu) -> Leaf(2^8, jnp).  The analogue of the reference's
    #: freely-mixed layer lists in one kernel type expression (reference
    #: tests/ntt-tests/recursive-sve-radix248-two13.hpp); autotunable.
    plan_spec: str | None = None
    #: Resolve knobs via the measure-and-cache autotuner at NTT build time.
    tune: bool = False

    # largest transform the iterative strategy handles before auto switches
    # to six-step
    ITERATIVE_MAX: int = field(default=1 << 13, repr=False)

    def __post_init__(self):
        if not _is_pow2(self.n) or self.n < 2:
            raise ValueError("n must be a power of two >= 2")
        mod = self.mod
        if (mod.modulus - 1) % self.n:
            raise ValueError(
                f"modulus lacks 2-adicity {self.n.bit_length() - 1} "
                f"(has {mod.two_adicity})"
            )
        if self.strategy not in ("auto", "iterative", "six_step"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.engine not in ("auto", "jnp", "mxu"):
            raise ValueError(
                f"unknown engine {self.engine!r} (engines: 'jnp', 'mxu', "
                "'auto'; the 'pallas' engine was removed)"
            )
        if self.modmul not in ("auto", "montgomery", "shoup", "solinas"):
            raise ValueError(f"unknown modmul engine {self.modmul!r}")
        if self.modmul == "solinas":
            from ..field.limb import solinas_capable

            if not solinas_capable(self.modulus):
                raise ValueError(
                    "solinas modmul requires a sparse-high modulus "
                    "N = 2^64 - (c*2^s - 1), bit_width(c*2^s) <= 42"
                )
        for name in ("max_fused", "chunk_elems"):
            v = getattr(self, name)
            if v is not None and not _is_pow2(v):
                raise ValueError(f"{name} must be a positive power of two, got {v}")
        if self.strategy == "six_step" or (
            self.strategy == "auto" and self.n > self.ITERATIVE_MAX
        ):
            n0, n1 = self.split
            if n0 * n1 != self.n or not (_is_pow2(n0) and _is_pow2(n1)):
                raise ValueError("n0 * n1 must equal n (powers of two)")
        if self.plan_spec is not None:
            from . import planner

            planner.build_plan_spec(self.n, self.plan_spec)  # validates

    @property
    def mod(self) -> Modulus:
        return Modulus(self.modulus, self.generator)

    @property
    def resolved_strategy(self) -> str:
        if self.strategy != "auto":
            return self.strategy
        return "iterative" if self.n <= self.ITERATIVE_MAX else "six_step"

    @property
    def split(self) -> tuple[int, int]:
        """(n0, n1) for six-step; balanced by default with n1 >= n0, matching
        the reference flagship 2^17 = 2^8 x 2^9 (README.md:18-68)."""
        if self.n0 is not None and self.n1 is not None:
            return self.n0, self.n1
        log2n = self.n.bit_length() - 1
        n0 = 1 << (log2n // 2)
        return n0, self.n // n0

    def with_(self, **kw) -> "NttConfig":
        return replace(self, **kw)
