"""Model and shape configurations: copies of ``repro/configs`` (plain
dataclasses, no framework code).  ``base.get_config(name)`` fills the
registry from ``all.py`` on first use."""
