"""The least bytes the flat pixel ring moves in an exact-spp segment
under the spp cap, counted from the cell's lanes and the segment's
admitted records and touched pixels alone, so that the count stays the
same whatever implements the ring (its torch gather, sort and scatters
today, or a kernel later):

- each lane's pixel id read (4 bytes) and its pixel's count read (4);
- each admitted record read (3 colour floats and a weight: 16);
- each pixel an admitted record lands on: its 4 film floats and its
  count read and written once (2 x 20);
- each lane's pixel after the raygen written (4).

A refused record need not be read, and a held lane moves nothing more
than its pixel id and count."""

from .roofline import F32

LANE_BYTES = 3 * F32
RECORD_BYTES = 4 * F32
PIXEL_BYTES = 4 * F32 + F32


def segment_bytes(lanes: int, admitted: float, touched: float) -> float:
    """The bytes a segment of ``lanes`` lanes moves that admits
    ``admitted`` records onto ``touched`` distinct pixels (means over a
    job)."""
    return (lanes * LANE_BYTES + admitted * RECORD_BYTES
            + touched * 2 * PIXEL_BYTES)
