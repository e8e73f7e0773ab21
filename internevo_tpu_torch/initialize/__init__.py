"""Config defaults and launch on one device (port of
``internevo_tpu/initialize``)."""

from .launch import args_sanity_check, launch  # noqa: F401
