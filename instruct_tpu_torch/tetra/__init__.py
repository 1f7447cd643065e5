"""The tetraploid (auto- and allotetraploid) engine of the port."""

from instruct_tpu_torch.tetra.combinatorics import (ClassTables,
                                                    build_class_tables)

__all__ = ["build_class_tables", "ClassTables"]
