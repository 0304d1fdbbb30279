from .pipeline import fused_profile, profile_arrays, profile_file  # noqa: F401
