from .core import (
    from_dataloader,
    from_file,
    from_file_to_file,
    from_files_to_files,
    from_probabilities,
)
