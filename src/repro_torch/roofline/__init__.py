"""Roofline terms of the dry run's steps and the tables made from them."""
