from .model_zoo import get_model  # noqa: F401
