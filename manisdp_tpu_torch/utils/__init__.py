from .checkpoint import load_state, save_state

__all__ = ["save_state", "load_state"]
