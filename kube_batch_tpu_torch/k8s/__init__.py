"""The Kubernetes front end's seams the port needs so far (see
``transport.py``)."""
