"""PAGE 2019 XML writing (port of origami_tpu/pagexml/pagexml.py)."""
