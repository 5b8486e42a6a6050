from .engine import GenerationConfig, GenerationEngine, make_serve_step  # noqa: F401
