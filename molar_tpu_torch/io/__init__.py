from .xtc import Frame, MalformedFileError, SeekError, XtcError, XtcHandler

__all__ = ["Frame", "MalformedFileError", "SeekError", "XtcError", "XtcHandler"]
