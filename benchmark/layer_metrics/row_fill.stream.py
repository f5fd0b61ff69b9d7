"""Pool (``serving.py``): the rows that carried a session's audio over the
rows stepped (the pool steps its whole capacity), summed over the ticks
after the traced stretch from the attributes of the program's
``pool.tick`` spans (``benchmark/program_spans.py``)."""

from benchmark import program_spans


def read(ctx, data, spans, trace):
    ticks = program_spans.stream_ticks(data)
    if not ticks:
        return None
    stepped = sum(t.attrs.get("rows_stepped", 0) for t in ticks)
    with_audio = sum(t.attrs.get("rows_with_audio", 0) for t in ticks)
    return with_audio / stepped if stepped else None
