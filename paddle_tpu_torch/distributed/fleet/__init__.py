from . import meta_parallel  # noqa: F401
