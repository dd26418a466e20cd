"""BLS12-381 curve and protocol constants.

Parity: values match the arkworks `ark-bls12-381` curve configuration used by the
reference (`curdleproofs/Cargo.toml:25`); protocol constants match
`curdleproofs/src/lib.rs:35` (N_BLINDERS) and `curdleproofs/src/crs.rs:15`
(CRS_EXTRA_POINTS).
"""

# --- Base field Fq (381-bit prime) ---
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB  # noqa: long hex literal

# --- Scalar field Fr (255-bit prime) ---
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Curve: y^2 = x^3 + 4 over Fq
CURVE_B = 4

# G1 cofactor
COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB

# G1 generator (affine)
G1_GENERATOR_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB  # noqa: long hex literal
G1_GENERATOR_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1  # noqa: long hex literal

# Montgomery parameters arkworks uses internally.  We do canonical-value math, but
# `Fr::rand`/`Fq::rand` in arkworks interpret the raw sampled bigint AS the Montgomery
# representation (ark-ff 0.4 `Fp::rand`), so bit-exact sampling needs R^-1 mod p.
FR_LIMBS64 = 4
FQ_LIMBS64 = 6
FR_MONT_R = (1 << 256) % R
FQ_MONT_R = (1 << 384) % Q
FR_MONT_R_INV = pow(FR_MONT_R, -1, R)
FQ_MONT_R_INV = pow(FQ_MONT_R, -1, Q)

# Number of bits masked off the top limb when sampling (ark-ff `SHAVE_BITS`).
FR_SHAVE_BITS = 1  # 256 - 255
FQ_SHAVE_BITS = 3  # 384 - 381

# --- Protocol constants (reference parity) ---
N_BLINDERS = 4          # src/lib.rs:35
CRS_EXTRA_POINTS = 3    # src/crs.rs:15

# Byte sizes (src/whisk.rs:21-25)
FIELD_ELEMENT_SIZE = 32
G1POINT_SIZE = 48
WHISK_SHUFFLE_PROOF_SIZE = 4496
TRACKER_PROOF_SIZE = 128

# Whisk layer defaults (src/whisk.rs:28-29)
WHISK_N = 128
WHISK_ELL = WHISK_N - N_BLINDERS
