from .library import ENCODING_TYPES, build_circuit  # noqa: F401
