"""Real frames decoded (never padding) over the window's wall time, from
its start to the completion of its last call"""


def read(record):
    if not record.get('frames') or not record['window_s']:
        return None
    return record['frames'] / record['window_s']
