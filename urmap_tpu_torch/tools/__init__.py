"""Tools of the port: tools/*.py counterparts that drive urmap_tpu_torch."""
