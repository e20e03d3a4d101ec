"""Scan execution (``scan``) and the numpy oracle engine (``oracle``)."""
