"""The plain references that decide a run's ``correct``.

``av1/``: a frozen numpy AV1 decoder (headers, the range decoder, the
coefficient and mode syntax, intra and inter prediction, the inverse
transforms, the loop filter, CDEF, loop restoration, superres, film
grain), the closure of the port's ``decoder/obu.py`` with its native and
device paths taken out. ``temporal_filter.py``: libaom's temporal filter
(``av1/encoder/temporal_filter.c``) as plain whole-frame PyTorch.

Nothing here imports the program under test: the reference works out
from the packets and the sources what the program derived.
"""
