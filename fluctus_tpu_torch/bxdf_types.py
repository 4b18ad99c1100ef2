"""BXDF type bit flags, mirroring src/bxdf_types.h:4-12."""

BXDF_DIFFUSE = 1 << 1
BXDF_GLOSSY = 1 << 2
BXDF_GGX_ROUGH_REFLECTION = 1 << 3
BXDF_IDEAL_REFLECTION = 1 << 4
BXDF_GGX_ROUGH_DIELECTRIC = 1 << 5
BXDF_IDEAL_DIELECTRIC = 1 << 6
BXDF_EMISSIVE = 1 << 7
BXDF_MIXED = 1 << 8

BXDF_SINGULAR_MASK = BXDF_IDEAL_REFLECTION | BXDF_IDEAL_DIELECTRIC

ALL_TYPES = (
    BXDF_DIFFUSE,
    BXDF_GLOSSY,
    BXDF_GGX_ROUGH_REFLECTION,
    BXDF_IDEAL_REFLECTION,
    BXDF_GGX_ROUGH_DIELECTRIC,
    BXDF_IDEAL_DIELECTRIC,
    BXDF_EMISSIVE,
    BXDF_MIXED,
)

_NAMES = {
    BXDF_DIFFUSE: "diffuse",
    BXDF_GLOSSY: "glossy",
    BXDF_GGX_ROUGH_REFLECTION: "rough_reflection",
    BXDF_IDEAL_REFLECTION: "ideal_reflection",
    BXDF_GGX_ROUGH_DIELECTRIC: "rough_dielectric",
    BXDF_IDEAL_DIELECTRIC: "ideal_dielectric",
    BXDF_EMISSIVE: "emissive",
    BXDF_MIXED: "mixed",
}


def is_singular(t: int) -> bool:
    return (t & BXDF_SINGULAR_MASK) != 0


def type_name(t: int) -> str:
    return _NAMES.get(t, "unknown")


def parse_shader_type(name: str):
    """Shader-name string -> type, matching src/scene.cpp:122-142.

    Returns (type, ok). Unknown names fall back to diffuse with ok=False,
    which triggers the material-inference heuristics.
    """
    table = {
        "diffuse": BXDF_DIFFUSE,
        "glossy": BXDF_GLOSSY,
        "rough_reflection": BXDF_GGX_ROUGH_REFLECTION,
        "ideal_reflection": BXDF_IDEAL_REFLECTION,
        "rough_dielectric": BXDF_GGX_ROUGH_DIELECTRIC,
        "ideal_dielectric": BXDF_IDEAL_DIELECTRIC,
        "emissive": BXDF_EMISSIVE,
    }
    if name in table:
        return table[name], True
    return BXDF_DIFFUSE, False
