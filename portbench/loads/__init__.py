"""Load generators, one a traffic kind (``traffic/<mix>.json`` names its
"kind"): set-up, the measured window, and the reference's judgement."""
