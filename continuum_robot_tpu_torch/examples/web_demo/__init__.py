"""The web demo: ``serve.py`` serves the beam rollout as JSON to ``index.html``."""
