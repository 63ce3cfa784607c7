"""Offline evaluation of saved renders (``run_evaluation``)."""
