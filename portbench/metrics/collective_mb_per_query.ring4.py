"""Megabytes (1e6 bytes) rank 0 handed to collectives per query, from the
port's collective recorder over the counted half."""


def read(measured):
    report = measured.reports[0]
    if report.collective_queries == 0:
        return None
    return report.collective_bytes / report.collective_queries / 1e6
