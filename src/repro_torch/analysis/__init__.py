"""Roofline analysis of the dry run's records (``launch/dryrun.py``)."""
