"""The least work of a step and of each kernel at a configuration's
shapes, one module per configuration (`work/<config>.py`), counted from
the shapes and not from any program."""
