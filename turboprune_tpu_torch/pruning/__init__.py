from .densities import generate_cyclical_schedule

__all__ = ["generate_cyclical_schedule"]
