"""The command-line clients: ``queue`` and ``whatif``."""
