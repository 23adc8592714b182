"""The session runtime, the scheduler configuration and the registries."""
