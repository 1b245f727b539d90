"""sventt_tpu: a JAX Number Theoretic Transform framework for GPUs.

A JAX/XLA implementation with the capabilities of the Terminus-IMRC/sve-ntt
reference library (see SURVEY.md): forward/inverse NTTs over 60-64-bit prime
fields, composed from radix-2 butterfly stages or int8 matrix products into
iterative, six-step and blocked six-step transforms, with multi-device
row-sharded transforms over a `jax.sharding.Mesh` whose six-step transpose is
an all-to-all collective.

Layout of the package (reference layer map in SURVEY.md section 1):

* ``field``    - L1 primitives: host Modulus constants, the golden model,
                 and u64-as-2xu32 limb arithmetic (Montgomery/Shoup modmul,
                 butterflies).
* ``ops``      - L2/L3: butterfly stage plans, the pure-jnp NTT engine, the
                 int8 matrix NTT engine, transposes, pointwise ops.
* ``plan``     - L4: NttConfig + planner + the public ``NTT`` wrapper that
                 owns device twiddle tables (the analogue of
                 reference include/sventt/wrapper.hpp).
* ``parallel`` - the multi-device layer (absent in the reference): meshes,
                 shard_map six-step, all-to-all transpose.
* ``apps``     - L5 applications: magic-series convolution pipeline, Kinnaes
                 closed form.
"""

from .field import (
    FLAGSHIP_GENERATOR,
    FLAGSHIP_MODULUS,
    GOLDILOCKS_MODULUS,
    TEST_GENERATOR,
    TEST_MODULUS,
    U64,
    FieldConsts,
    GoldenNTT,
    Modulus,
)

__version__ = "0.1.0"
